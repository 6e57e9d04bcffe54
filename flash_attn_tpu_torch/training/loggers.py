"""Metric loggers (counterpart of `flash_attn_tpu/training/loggers.py`:
`StdoutLogger:18`, `JSONLLogger:26`, `CSVLogger:41`, `LoggerCollection:192`,
`make_loggers:205`).

`make_loggers` returns a multiplexer with `.log(step, metrics)` and
`.close()`.  The TensorBoard, wandb and mlflow backends raise
`NotImplementedError`.
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path


class StdoutLogger:
    def log(self, step: int, metrics: dict):
        print({"step": step, **metrics}, flush=True)

    def close(self):
        pass


class JSONLLogger:
    def __init__(self, out_dir):
        self.path = Path(out_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def log(self, step: int, metrics: dict):
        rec = {"step": step, "time": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class CSVLogger:
    def __init__(self, out_dir):
        self.path = Path(out_dir) / "metrics.csv"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", newline="")
        self._writer = None
        self._fields = None

    def log(self, step: int, metrics: dict):
        rec = {"step": step, **metrics}
        if self._writer is None:
            self._fields = list(rec)
            self._writer = csv.DictWriter(self._f, fieldnames=self._fields,
                                          extrasaction="ignore")
            if self._f.tell() == 0:
                self._writer.writeheader()
        if any(k not in self._fields for k in rec):
            # A new metric mid-run: rewrite the file under the union header,
            # so every row stays aligned with it.
            self._fields = list(dict.fromkeys(self._fields + list(rec)))
            self._f.close()
            with open(self.path, newline="") as f:
                old_rows = list(csv.DictReader(f))
            self._f = open(self.path, "w", newline="")
            self._writer = csv.DictWriter(self._f, fieldnames=self._fields,
                                          extrasaction="ignore")
            self._writer.writeheader()
            for row in old_rows:
                self._writer.writerow(row)
        self._writer.writerow(rec)
        self._f.flush()

    def close(self):
        self._f.close()


class LoggerCollection:
    def __init__(self, loggers):
        self.loggers = loggers

    def log(self, step: int, metrics: dict):
        for lg in self.loggers:
            lg.log(step, metrics)

    def close(self):
        for lg in self.loggers:
            lg.close()


def make_loggers(names, out_dir="runs") -> LoggerCollection:
    out = []
    for name in names or ["stdout"]:
        if name == "stdout":
            out.append(StdoutLogger())
        elif name == "jsonl":
            out.append(JSONLLogger(out_dir))
        elif name == "csv":
            out.append(CSVLogger(out_dir))
        elif name in ("tensorboard", "tb", "wandb", "mlflow"):
            raise NotImplementedError(f"the {name} logger is not ported yet")
        else:
            raise ValueError(f"unknown logger {name!r}")
    return LoggerCollection(out)
