"""MusicGen-medium — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284]. 48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.
EnCodec (mel + conv codec) is STUBBED per the assignment: input_specs supplies
precomputed frame embeddings (frontend='embeds'); labels are codebook ids."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=6144, vocab=2048, frontend="embeds",
    max_seq=32768, source="arXiv:2306.05284 (MusicGen)")

SMOKE = ArchConfig(
    name="musicgen-smoke", family="audio", n_layers=2, d_model=192,
    n_heads=3, n_kv_heads=3, d_ff=384, vocab=128, frontend="embeds",
    param_dtype="float32", compute_dtype="float32", remat=False,
    attn_chunk=64, loss_chunk=64, source="reduced musicgen")
