"""StarCoder2-15B — dense GQA, RoPE, sliding-window 4096, learned bias
[arXiv:2402.19173]. 40L d_model=6144 48H (kv=4) d_ff=24576 vocab=49152."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=4, d_ff=24576, vocab=49152, qkv_bias=True,
    rope_theta=1e5, window=4096, max_seq=1048576,
    source="arXiv:2402.19173 (StarCoder2)")

SMOKE = ArchConfig(
    name="starcoder2-smoke", family="dense", n_layers=2, d_model=256,
    n_heads=8, n_kv_heads=2, d_ff=512, vocab=512, qkv_bias=True, window=64,
    param_dtype="float32", compute_dtype="float32", remat=False,
    attn_chunk=64, loss_chunk=64, source="reduced starcoder2")
