"""Metric loggers (counterpart of `flash_attn_tpu/training/loggers.py`:
`StdoutLogger:18`, `JSONLLogger:26`, `CSVLogger:41`,
`TensorBoardLogger:79`, `WandbLogger:121`, `MLFlowLogger:158`,
`LoggerCollection:192`, `make_loggers:205`).

`make_loggers` returns a multiplexer with `.log(step, metrics)` and
`.close()`.  The TensorBoard logger writes event files through
`tensorboardX` and is dropped where that package is missing; wandb and
mlflow fall back to a JSONL logger where their package is missing or their
run cannot start, as in JAX.
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


class TensorBoardLogger:
    """Scalars into an event file under `out_dir/tb` (needs
    `tensorboardX`; `available` is False without it)."""

    def __init__(self, out_dir):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._writer = None
        else:
            self._writer = SummaryWriter(str(Path(out_dir) / "tb"))

    @property
    def available(self):
        return self._writer is not None

    def log(self, step: int, metrics: dict):
        if self._writer is None:
            return
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self._writer.add_scalar(k, v, step)

    def close(self):
        if self._writer is not None:
            self._writer.close()


class WandbLogger:
    """Weights & Biases; `available` is False where `wandb` is missing or
    its run does not start."""

    def __init__(self, out_dir, project="flash-attn-tpu", name=None,
                 config=None):
        try:
            import wandb

            self._run = wandb.init(project=project, name=name,
                                   config=config or {}, dir=str(out_dir),
                                   reinit=True)
        except Exception:
            self._run = None

    @property
    def available(self):
        return self._run is not None

    def log(self, step: int, metrics: dict):
        if self._run is not None:
            self._run.log({k: v for k, v in metrics.items()
                           if isinstance(v, (int, float))}, step=step)

    def close(self):
        if self._run is not None:
            self._run.finish()


class MLFlowLogger:
    """MLflow on a local `out_dir/mlruns` file store; `available` is False
    where `mlflow` is missing or its run does not start."""

    def __init__(self, out_dir, experiment="flash-attn-tpu", run_name=None):
        try:
            import mlflow

            mlflow.set_tracking_uri(f"file:{Path(out_dir) / 'mlruns'}")
            mlflow.set_experiment(experiment)
            mlflow.start_run(run_name=run_name)
            self._mlflow = mlflow
        except Exception:
            self._mlflow = None

    @property
    def available(self):
        return self._mlflow is not None

    def log(self, step: int, metrics: dict):
        if self._mlflow is not None:
            self._mlflow.log_metrics(
                {k.replace("/", "_"): float(v) for k, v in metrics.items()
                 if isinstance(v, (int, float))}, step=step)

    def close(self):
        if self._mlflow is not None:
            self._mlflow.end_run()


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
        elif name in ("tensorboard", "tb"):
            tb = TensorBoardLogger(out_dir)
            if tb.available:
                out.append(tb)
        elif name in ("wandb", "mlflow"):
            lg = (WandbLogger if name == "wandb" else MLFlowLogger)(out_dir)
            out.append(lg if lg.available else JSONLLogger(out_dir))
        else:
            raise ValueError(f"unknown logger {name!r}")
    return LoggerCollection(out)
