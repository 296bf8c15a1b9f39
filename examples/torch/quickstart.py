"""Quickstart on the PyTorch port: build a small decoder LM from the port's
public API, train a few steps on synthetic data, then greedy-decode with the
KV cache.

  PYTHONPATH=src python examples/torch/quickstart.py [--arch mixtral-8x7b]
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu

Any configuration of the registry works via --arch (its reduced SMOKE
variant). It runs on the card by default, on the CPU with --device cpu.

``--dry-run`` runs the training step through ``repro_torch.launch.dryrun``
on ``meta`` tensors: shapes, bytes and flops, nothing allocated, no card.
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="edl-paper")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dry-run", action="store_true",
                    help="the training step on meta tensors (no training)")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticTokenDataset
    from repro_torch.devices import resolve_device
    from repro_torch.models import model as M
    from repro_torch.models.cache import init_cache
    from repro_torch.optim import adamw
    from repro_torch.training.step import init_train_state, make_train_step

    cfg = get_config(args.arch, smoke=True)
    print(f"arch={cfg.name} family={cfg.family} layers={cfg.n_layers} "
          f"d_model={cfg.d_model}")
    opt = adamw(3e-3)

    if args.dry_run:
        from repro_torch.configs.base import InputShape
        from repro_torch.launch.dryrun import dryrun
        rec = dryrun(cfg, InputShape("rt", args.seq, args.batch, "train"),
                     (1, 1))
        print(f"dry-run {rec['status']}: {rec['arg_bytes']} argument bytes, "
              f"peak {rec['per_device_bytes']} bytes, "
              f"{rec['flops_per_slot']:.3e} flops a step")
        return 0 if rec["status"] == "OK" else 1

    dev = resolve_device(args.device)
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(0), dev)
    step = make_train_step(cfg, opt, [dev])
    ds = SyntheticTokenDataset(1024, args.seq, cfg.vocab,
                               embeds=cfg.frontend == "embeds",
                               d_model=cfg.d_model)
    slots = [state]
    for i in range(args.steps):
        raw = ds.read((i * args.batch) % (1024 - args.batch), args.batch)
        batch = {k: v for k, v in raw.items() if k != "sample_ids"}
        if cfg.frontend == "embeds":
            batch.pop("tokens", None)
        slots, metrics = step(slots, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {float(metrics['loss']):.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}")

    if cfg.frontend == "tokens":
        print("greedy decode with KV cache:")
        params = slots[0]["params"]
        cache = init_cache(cfg, 1, 16, device=dev)
        tok = torch.ones((1, 1), dtype=torch.long, device=dev)
        out = []
        with torch.inference_mode():
            for _ in range(12):
                ids, cache = M.serve_step(cfg, params, {"tokens": tok},
                                          cache)
                tok = ids[:, None].long()
                out.append(int(ids[0]))
        print("generated:", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
