"""RWKV6 "Finch" 1.6B — attention-free SSM with data-dependent decay
[arXiv:2404.05892]. 24L d_model=2048 d_ff=7168 vocab=65536, head_dim 64."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=7168, vocab=65536, attn_kind="none",
    ssm=SSMConfig(kind="rwkv6", rwkv_head_dim=64),
    max_seq=1048576, source="arXiv:2404.05892 (RWKV6 Finch)")

SMOKE = ArchConfig(
    name="rwkv6-smoke", family="ssm", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=4, d_ff=512, vocab=512, attn_kind="none",
    ssm=SSMConfig(kind="rwkv6", rwkv_head_dim=64),
    param_dtype="float32", compute_dtype="float32", remat=False,
    attn_chunk=64, loss_chunk=64, source="reduced rwkv6")
