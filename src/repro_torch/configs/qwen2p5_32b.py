"""Qwen2.5-32B — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family].
64L d_model=5120 40H (kv=8) d_ff=27648 vocab=152064."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=27648, vocab=152064, qkv_bias=True,
    rope_theta=1e6, max_seq=131072, source="hf:Qwen/Qwen2.5-32B")

SMOKE = ArchConfig(
    name="qwen-smoke", family="dense", n_layers=2, d_model=320,
    n_heads=5, n_kv_heads=1, d_ff=640, vocab=512, qkv_bias=True,
    param_dtype="float32", compute_dtype="float32", remat=False,
    attn_chunk=64, loss_chunk=64, source="reduced qwen2.5")
