"""Serving on the PyTorch port: batched prefill + decode with the KV/SSM
cache across three architecture families (dense, MoE, attention-free
RWKV6), through ``repro_torch.core.serving.serve_batch``, the wave the
cluster's serving tier runs for each replica.

  PYTHONPATH=src python examples/torch/elastic_serving.py
  PYTHONPATH=src python examples/torch/elastic_serving.py --device cpu
"""
import argparse
import sys
import time

ARCHS = ("phi3-mini-3.8b", "mixtral-8x7b", "rwkv6-1.6b")


def serve(arch: str, device, batch: int = 4, prompt_len: int = 32,
          gen_len: int = 16):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.serving import make_decode_fn, serve_batch
    from repro_torch.models import model as M

    cfg = get_config(arch, smoke=True)
    if cfg.frontend != "tokens":
        return None
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(1)
                            ).to(device)
    decode = make_decode_fn(cfg)
    t0 = time.monotonic()
    generated, cache = serve_batch(cfg, params, prompts, gen_len,
                                   decode=decode)
    dt = time.monotonic() - t0
    toks = batch * (prompt_len + gen_len)
    print(f"{cfg.name:24s} {toks / dt:8.1f} tok/s  "
          f"cache_pos={int(cache['pos'])}  "
          f"sample row0: {[int(t) for t in generated[0, :8]]}")
    return toks / dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args(argv)
    from repro_torch.devices import resolve_device
    dev = resolve_device(args.device)
    for arch in ARCHS:
        serve(arch, dev, gen_len=args.gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
