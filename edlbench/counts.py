"""The yardstick's arithmetic: the chip's peaks, each port kernel's bytes
and operations from its shapes, and a training step's model flops, whose
parts (``matmul_params``, ``mixer_forward_flops``) each model kind's
module counts (``reference/<model>.py``).

``attention_work`` and ``wkv_work`` are frozen copies of the kernel
counts in ``chip_smoke.py``: bytes count each input read once and each
output written once; operations are 4·D a visible (query, key) pair for
the forward, 6·D for dQ and 8·D for dK/dV, and 5·hd² a token and head for
each WKV6 scan.
"""
from __future__ import annotations

from edlbench.reference import kind

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

ATTN_NAMES = ("flash_attn_fwd_tc", "flash_attn_bwd_dq_tc",
              "flash_attn_bwd_dkdv_tc")
WKV_NAMES = ("wkv6_fwd", "wkv6_bwd_dr", "wkv6_bwd_dk", "wkv6_bwd_dv")


def causal_pairs(L: int) -> int:
    """(query, key) pairs a causal mask lets through at Lq = Lk = L."""
    return L * (L + 1) // 2


def attention_work(names, B, Hq, Hkv, Lq, Lk, D, esz, pairs) -> dict:
    """(bytes: inputs read once + outputs written once, flops) of each
    flash kernel on these inputs, by ``names`` (forward, dQ, dK/dV);
    ``pairs`` counts the visible pairs over batch and heads."""
    n_qo = B * Hq * Lq * D * esz        # one [B,Hq,Lq,D] tensor
    n_kv = B * Hkv * Lk * D * esz       # one [B,Hkv,Lk,D] tensor
    n_row = B * Hq * Lq * 4             # lse or delta, fp32
    fwd_n, dq_n, kv_n = names
    return {fwd_n: (2 * n_qo + 2 * n_kv + n_row, 4 * D * pairs),
            dq_n: (4 * n_qo + 2 * n_kv + 2 * n_row, 6 * D * pairs),
            kv_n: (2 * n_qo + 4 * n_kv + 2 * n_row, 8 * D * pairs)}


def wkv_work(B, L, H, hd) -> dict:
    """(bytes: inputs read once + outputs written once, flops) of each WKV6
    kernel. Per (b, t, h) each scan does 5 hd^2 flops: a matrix-vector
    product with the hd x hd state (2 hd^2) and its update diag(w) S + x y^T
    (3 hd^2)."""
    seq = B * L * H * hd * 4            # one [B,L,H,hd] fp32 tensor
    st = B * H * hd * hd * 4            # one [B,H,hd,hd] state
    vec = B * H * hd * 4                # one [B,H,hd] per-(b, h) vector
    u = H * hd * 4
    scan = 5 * B * L * H * hd * hd
    return {
        "wkv6_fwd": (5 * seq + 2 * st + u, scan),
        "wkv6_bwd_dr": (7 * seq + 2 * st + u + vec, scan),
        "wkv6_bwd_dk": (8 * seq + 2 * st + 2 * u + vec,
                        scan + (B - 1) * H * hd),
        "wkv6_bwd_dv": (5 * seq + st + u, scan),
    }


def bound_s(nbytes: float, flops: float, peak_flops: float) -> float:
    """The least time the chip could take: the larger of the two terms."""
    return max(nbytes / PEAK_HBM_BYTES, flops / peak_flops)


def _calls(model: dict, kinds: tuple) -> list:
    """How many times each kernel kind runs a layer and a data group in a
    step: the forward twice under remat (its recomputation), each backward
    kernel once."""
    return [2 if model.get("remat", True) else 1] + [1] * (len(kinds) - 1)


def attention_bound_s(model: dict, traffic: dict, p: int) -> float:
    """The attention kernels' least time a step at ``p`` data groups: every
    call the step makes, remat's recomputed forward included."""
    B = traffic["global_batch"] // p
    L = traffic["seq_len"]
    H, Hkv = model["num_attention_heads"], model["num_key_value_heads"]
    D = model["hidden_size"] // H
    work = attention_work(ATTN_NAMES, B, H, Hkv, L, L, D, 2,
                          B * H * causal_pairs(L))
    calls = _calls(model, ATTN_NAMES)
    per_layer = sum(c * bound_s(*work[n], PEAK_BF16_FLOPS)
                    for c, n in zip(calls, ATTN_NAMES))
    return p * model["num_hidden_layers"] * per_layer


def wkv_bound_s(model: dict, traffic: dict, p: int) -> float:
    """The WKV6 kernels' least time a step at ``p`` data groups (fp32 on
    the CUDA cores: 67 TFLOP/s)."""
    B = traffic["global_batch"] // p
    hd = model["head_size"]
    H = model["hidden_size"] // hd
    work = wkv_work(B, traffic["seq_len"], H, hd)
    calls = _calls(model, WKV_NAMES)
    per_layer = sum(c * bound_s(*work[n], PEAK_FP32_FLOPS)
                    for c, n in zip(calls, WKV_NAMES))
    return p * model["num_hidden_layers"] * per_layer


def matmul_params(model: dict) -> int:
    """Parameters that enter a matrix product a token, by the
    configuration's kind (``reference/<model>.py``)."""
    return kind(model).matmul_params(model)


def mixer_forward_flops(model: dict, B: int, L: int) -> int:
    """The token mixer's forward flops over a batch of B rows of L, by the
    configuration's kind."""
    return kind(model).mixer_forward_flops(model, B, L)


def step_model_flops(model: dict, B: int, L: int) -> int:
    """A training step's model flops: 6 x the matmul parameters x tokens,
    plus 3 x the mixer's forward; recomputation is not counted."""
    return 6 * matmul_params(model) * B * L + 3 * mixer_forward_flops(
        model, B, L)
