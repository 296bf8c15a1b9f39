"""The ``llama`` kind (Phi-3-mini): pre-norm blocks of RMSNorm, split-half
RoPE, causal multi-head attention (grouped where kv heads < heads), a
SwiGLU MLP, a final RMSNorm and an untied unembedding; mean cross-entropy
over every position. Phi-3's fused qkv and gate/up matrices are kept
apart, which is the same product; its LongRoPE scaling is not modelled.
"""
from __future__ import annotations

import math

import torch.nn.functional as F

from edlbench.counts import causal_pairs
from edlbench.reference import model as ref

# the configuration's keys and the port config's fields
PORT_FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
               "num_attention_heads": "n_heads",
               "num_key_value_heads": "n_kv_heads",
               "intermediate_size": "d_ff", "vocab_size": "vocab",
               "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
               "tie_word_embeddings": "tie_embeddings", "remat": "remat",
               "max_position_embeddings": "max_seq"}

# the CPU tests' sizes
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=128, vocab_size=256,
            reference_attn_chunk=16, reference_loss_chunk=16)


def fixed(m: dict) -> dict:
    """The keys whose value the port fixes: plain RoPE."""
    return {"rope_scaling": None}


def param_specs(m: dict) -> list:
    """The tree; a matrix ``[d_in, d_out]`` is drawn with std ``1 /
    sqrt(d_in)``, the embedding with ``1 / sqrt(vocab)``."""
    D, n, V = m["hidden_size"], m["num_hidden_layers"], m["vocab_size"]
    F_ = m["intermediate_size"]
    H, Hkv = m["num_attention_heads"], m["num_key_value_heads"]
    Dh = D // H
    top = {"embed/table": ((V, D), "normal", 1.0 / math.sqrt(V)),
           "final_norm/scale": ((D,), "ones", 0.0),
           "unembed/w": ((D, V), "normal", 1.0 / math.sqrt(D))}
    layer = {"norm1/scale": ((D,), "ones", 0.0),
             "norm2/scale": ((D,), "ones", 0.0),
             "mixer/wq/w": ((D, H * Dh), "normal", 1 / math.sqrt(D)),
             "mixer/wk/w": ((D, Hkv * Dh), "normal", 1 / math.sqrt(D)),
             "mixer/wv/w": ((D, Hkv * Dh), "normal", 1 / math.sqrt(D)),
             "mixer/wo/w": ((H * Dh, D), "normal", 1 / math.sqrt(H * Dh)),
             "ffn/wi_gate": ((D, F_), "normal", 1 / math.sqrt(D)),
             "ffn/wi_up": ((D, F_), "normal", 1 / math.sqrt(D)),
             "ffn/wo": ((F_, D), "normal", 1 / math.sqrt(F_))}
    return ref.stacked_specs(top, layer, n)


def _layer(m, mm, x, n1, wq, wk, wv, wo, n2, wg, wu, wd, rnd=ref.same):
    B, L, D = x.shape
    H, Hkv = m["num_attention_heads"], m["num_key_value_heads"]
    Dh = D // H
    eps = m["rms_norm_eps"]
    h = ref.rmsnorm(x, n1, eps)
    q = mm(h, wq).view(B, L, H, Dh).transpose(1, 2)
    k = mm(h, wk).view(B, L, Hkv, Dh).transpose(1, 2)
    v = mm(h, wv).view(B, L, Hkv, Dh).transpose(1, 2)
    q, k = ref.rope(q, m["rope_theta"]), ref.rope(k, m["rope_theta"])
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    o = ref.attention(q, k, v, mm, m["reference_attn_chunk"])
    x = x + mm(o.transpose(1, 2).reshape(B, L, D), wo)
    h = ref.rmsnorm(x, n2, eps)
    return x + mm(F.silu(mm(h, wg)) * mm(h, wu), wd)


LAYER_ARGS = ("norm1/scale", "mixer/wq/w", "mixer/wk/w", "mixer/wv/w",
              "mixer/wo/w", "norm2/scale", "ffn/wi_gate", "ffn/wi_up",
              "ffn/wo")


def loss_sum(m: dict, P: dict, tokens, labels, low: bool = False):
    return ref.stacked_loss_sum(m, P, tokens, labels, low, _layer,
                                LAYER_ARGS)


def matmul_params(m: dict) -> int:
    """Parameters that enter a matrix product a token: the layers' and the
    head's, not the embedding lookup."""
    D, n, V = m["hidden_size"], m["num_hidden_layers"], m["vocab_size"]
    F_ = m["intermediate_size"]
    H, Hkv = m["num_attention_heads"], m["num_key_value_heads"]
    Dh = D // H
    return n * (2 * D * H * Dh + 2 * D * Hkv * Dh + 3 * D * F_) + D * V


def mixer_forward_flops(m: dict, B: int, L: int) -> int:
    """Causal attention's forward flops over B rows of L: 4·D a visible
    (query, key) pair and head."""
    H = m["num_attention_heads"]
    D = m["hidden_size"] // H
    return m["num_hidden_layers"] * 4 * D * B * H * causal_pairs(L)
