"""Architecture config system.

Each ported architecture gets a ``configs/<id>.py`` exporting ``CONFIG``
(the exact published shape) and ``SMOKE`` (a reduced same-family variant for
CPU tests). The dataclasses are those of the JAX package, field for field,
so a config means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

AttnKind = Literal["gqa", "mla", "none"]
Frontend = Literal["tokens", "embeds"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared: int = 0           # shared experts (deepseek-v2 style)
    every: int = 1              # MoE every Nth layer (jamba: 2), dense otherwise
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: Literal["rwkv6", "mamba"] = "mamba"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0            # 0 -> ceil(d_model/16)
    rwkv_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                   # 0 -> d_model // n_heads
    attn_kind: AttnKind = "gqa"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 0                     # >0 -> sliding-window attention
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid: period layout; e.g. jamba "msmsmsms"-style string, m=mamba a=attn
    hybrid_pattern: str = ""            # e.g. "mmmammmm" (1 attn per 8)
    frontend: Frontend = "tokens"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq: int = 131072
    # input (embedding) dropout rate; the port's train step threads no RNG
    # into the loss yet, so only dropout == 0 configs are on its path
    dropout: float = 0.0
    # runtime knobs
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 1024              # kv-chunk for flash-style attention
    loss_chunk: int = 1024              # seq-chunk for x-ent against big vocabs
    scan_layers: bool = True
    swa_pruned: bool = True             # window-pruned SWA (False = masked full)
    full_unroll: bool = False           # unroll inner chunk loops (cost mode)
    remat_group: int = 1                # periods per remat block
    chunked_wkv: bool = False           # RWKV6: chunked parallel form
    wkv_chunk: int = 32
    mamba_chunk: int = 128
    source: str = ""                    # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is supported (SSM/hybrid/SWA)."""
        return self.family in ("ssm", "hybrid") or self.window > 0

    def _layer_is_moe(self, i: int) -> bool:
        if self.moe is None or self.moe.n_experts == 0:
            return False
        return (i % self.moe.every) == (self.moe.every - 1)


# CLI aliases matching the assignment sheet
ALIASES = {
    "rwkv6-1.6b": "rwkv6_1p6b", "jamba-v0.1-52b": "jamba_v01_52b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "phi3-mini-3.8b": "phi3_mini_3p8b", "musicgen-medium": "musicgen_medium",
    "starcoder2-15b": "starcoder2_15b", "qwen2.5-32b": "qwen2p5_32b",
    "deepseek-v2-236b": "deepseek_v2_236b", "mistral-nemo-12b": "mistral_nemo_12b",
    "mixtral-8x7b": "mixtral_8x7b", "edl-paper": "edl_paper",
}


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    try:
        mod = importlib.import_module(f"repro_torch.configs.{arch}")
    except ModuleNotFoundError as e:
        if e.name != f"repro_torch.configs.{arch}":
            raise
        raise ValueError(f"architecture {arch!r} is not yet ported") from None
    return mod.SMOKE if smoke else mod.CONFIG
