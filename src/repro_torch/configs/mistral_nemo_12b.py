"""Mistral-Nemo 12B — dense GQA, 128k context, head_dim 128
[hf:mistralai/Mistral-Nemo-Base-2407]. 40L d_model=5120 32H (kv=8) d_ff=14336
vocab=131072."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072, head_dim=128,
    rope_theta=1e6, max_seq=131072,
    source="hf:mistralai/Mistral-Nemo-Base-2407")

SMOKE = ArchConfig(
    name="nemo-smoke", family="dense", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab=512, head_dim=32,
    param_dtype="float32", compute_dtype="float32", remat=False,
    attn_chunk=64, loss_chunk=64, source="reduced mistral-nemo")
