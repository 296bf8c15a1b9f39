"""LLaVA-NeXT (Mistral-7B backbone) — anyres tiling VLM
[hf:llava-hf/llava-v1.6-mistral-7b-hf]. The vision tower + projector are
STUBBED per the assignment: input_specs supplies patch/frame embeddings; this
config is the language decoder that consumes them (frontend='embeds')."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000, rope_theta=1e6,
    frontend="embeds", max_seq=32768,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf")

SMOKE = ArchConfig(
    name="llava-smoke", family="vlm", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab=512, frontend="embeds",
    param_dtype="float32", compute_dtype="float32", remat=False,
    attn_chunk=64, loss_chunk=64, source="reduced llava")
