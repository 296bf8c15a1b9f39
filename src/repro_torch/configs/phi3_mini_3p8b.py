"""Phi-3-mini 3.8B — dense, RoPE SwiGLU GQA [arXiv:2404.14219].
32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064,
    max_seq=131072, source="arXiv:2404.14219 (Phi-3)")

SMOKE = ArchConfig(
    name="phi3-smoke", family="dense", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
    param_dtype="float32", compute_dtype="float32", remat=False,
    attn_chunk=64, loss_chunk=64, source="reduced phi3")
