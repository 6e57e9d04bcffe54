"""CLI: `python -m flash_attn_tpu_torch.training.run [--config cfg.yaml]
[a.b=c ...]` (counterpart of `flash_attn_tpu/training/run.py:9-42`).

Trains on the CUDA device with the JAX package's defaults (GPT-2 small,
seq_len 1024, batch 8, bf16 autocast over fp32 weights, AdamW 6e-4) unless
overridden, e.g. `trainer.max_steps=20 trainer.log_every=5`.
"""

from __future__ import annotations

import argparse
import ast


def parse_overrides(kvs):
    """["a.b=1", ...] -> {"a": {"b": 1}}; values are Python literals where
    they parse as one, else strings."""
    out = {}
    for kv in kvs:
        key, _, val = kv.partition("=")
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        d = out
        parts = key.split(".")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return out


def main(argv=None):
    from flash_attn_tpu_torch.training.config import load_config
    from flash_attn_tpu_torch.training.trainer import train

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, parse_overrides(args.overrides))
    return train(cfg)


if __name__ == "__main__":
    main()
