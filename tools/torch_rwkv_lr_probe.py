#!/usr/bin/env python3
"""Whether a short full-width run of the PyTorch port lowers the loss.

Builds the port's ``ElasticTrainer`` on a full-width architecture
(``--arch``, default ``rwkv6-1.6b``; batch 8, sequence 1024, the seed and
synthetic data of ``launch/train.py``, one slot) once per learning rate in
``--lrs`` and takes ``--steps`` AdamW steps on fresh batches of the data
stream. The synthetic
tokens are uniform noise, so a fresh batch can only show the model moving
toward the uniform distribution; lr 0 gives the spread of the loss between
batches at the initial weights. Prints one JSON line per learning rate with
the losses and gradient norms, beside the card's name and power limit. Run
from the repo root on a machine with a card:

    python3 tools/torch_rwkv_lr_probe.py [--lrs 0,1e-4,1e-3,1e-2] \\
        [--dtype float32]
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--lrs", default="0,1e-4,1e-3,1e-2")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="params and compute (default: the config's)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import ElasticTrainer
    from repro_torch.optim import adamw

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cfg = get_config(args.arch)
    if args.dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.dtype,
                                  compute_dtype=args.dtype)
    for lr in (float(x) for x in args.lrs.split(",")):
        with ElasticTrainer(cfg, global_batch=8, seq_len=1024,
                            init_parallelism=1, optimizer=adamw(lr),
                            n_samples=1024, d_partitions=16,
                            devices=["cuda:0"], use_aot=False) as trainer:
            ms = [trainer.step() for _ in range(args.steps)]
        print(json.dumps({"arch": cfg.name, "dtype": cfg.param_dtype,
                          "lr": lr, "losses": [m["loss"] for m in ms],
                          "grad_norms": [m["grad_norm"] for m in ms],
                          "card": card}), flush=True)
        del trainer
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
