"""Mixtral-8x7B — MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088]. 32L d_model=4096 32H (kv=8) d_ff_expert=14336 vocab=32000."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000, window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336, every=1),
    max_seq=1048576, source="arXiv:2401.04088 (Mixtral)")

SMOKE = ArchConfig(
    name="mixtral-smoke", family="moe", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab=512, window=64,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=512, every=1),
    param_dtype="float32", compute_dtype="float32", remat=False,
    attn_chunk=64, loss_chunk=64, source="reduced mixtral")
