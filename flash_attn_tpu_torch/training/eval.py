"""Evaluation CLI (counterpart of `flash_attn_tpu/training/eval.py`).

    python -m flash_attn_tpu_torch.training.eval --config cfg.yaml \\
        [--checkpoint step_dir] [--ema] [--steps N] [a.b=c ...]

Loads a checkpoint (the newest under `trainer.checkpoint_dir`, or an
explicit `step_<n>` directory), runs `Trainer.evaluate` over the configured
data and prints {"step", "eval_loss", "perplexity", "ema"} as one JSON
line.  With an explicit checkpoint the loader starts from its beginning, as
JAX's CLI does (`eval.py:41-64`); the newest checkpoint restores the loader
too.  `--ema` evaluates the EMA parameters.  Runs on the CUDA device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None, device=None):
    from flash_attn_tpu_torch.training.config import load_config
    from flash_attn_tpu_torch.training.run import parse_overrides
    from flash_attn_tpu_torch.training.trainer import Trainer

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="explicit checkpoint step dir (default: latest)")
    ap.add_argument("--ema", action="store_true",
                    help="evaluate the EMA parameters")
    ap.add_argument("--steps", type=int, default=0,
                    help="override trainer.eval_steps")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    cfg = load_config(args.config, parse_overrides(args.overrides))
    cfg.trainer.resume = False
    if args.steps:
        cfg.trainer.eval_steps = args.steps
    trainer = Trainer(cfg, device=device)
    if args.checkpoint:
        trainer.load_checkpoint(args.checkpoint, loader=False)
    else:
        trainer.maybe_resume()
    loss = trainer.evaluate(use_ema=args.ema)
    result = {
        "step": trainer.step,
        "eval_loss": round(loss, 6),
        "perplexity": round(float(np.exp(loss)), 4),
        "ema": bool(args.ema),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
