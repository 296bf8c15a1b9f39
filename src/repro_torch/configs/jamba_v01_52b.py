"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]. 32L d_model=4096 32H(kv=8) d_ff=14336 vocab=65536."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536,
    hybrid_pattern="mmmammmm",          # 1 attention per 8 layers
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, every=2),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    max_seq=262144, source="arXiv:2403.19887 (Jamba)")

SMOKE = ArchConfig(
    name="jamba-smoke", family="hybrid", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
    hybrid_pattern="ma",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=512, every=2),
    ssm=SSMConfig(kind="mamba", d_state=8, d_conv=4, expand=2),
    param_dtype="float32", compute_dtype="float32", remat=False,
    attn_chunk=64, loss_chunk=64, source="reduced jamba")
