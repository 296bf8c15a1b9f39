"""DeepSeek-V2 236B — MLA (kv_lora=512) + MoE 2 shared + 160 routed top-6
[arXiv:2405.04434]. 60L d_model=5120 128H d_ff_expert=1536 vocab=102400."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=1536, vocab=102400, attn_kind="mla",
    mla=MLAConfig(kv_lora=512, q_lora=1536, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
                  every=1),
    max_seq=131072, source="arXiv:2405.04434 (DeepSeek-V2)")

SMOKE = ArchConfig(
    name="deepseek-smoke", family="moe", n_layers=2, d_model=256,
    n_heads=8, n_kv_heads=8, d_ff=128, vocab=512, attn_kind="mla",
    mla=MLAConfig(kv_lora=64, q_lora=96, qk_nope_dim=32, qk_rope_dim=16,
                  v_head_dim=32),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, n_shared=1, every=1),
    param_dtype="float32", compute_dtype="float32", remat=False,
    attn_chunk=64, loss_chunk=64, source="reduced deepseek-v2")
