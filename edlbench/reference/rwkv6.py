"""The ``rwkv6`` kind: pre-norm blocks of an RWKV6 time-mix (static
token-shift mixes, a decay LoRA ``exp(-exp(clamp(w0 + tanh(x W_a) W_b,
-8, 4)))``, the bonus ``u``, a per-head group norm, a SiLU gate) and a
channel mix (``sigmoid(x_r W_r) * relu(x_k W_k)^2 W_v``). Departures from
the published Finch: the token-shift mixes are static (no ddlerp LoRA),
the norms are RMSNorm, and the group norm has a scale and no bias. Under
``low`` the WKV6 inputs are rounded to float8 too.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from edlbench.reference import model as ref

# the configuration's keys and the port config's fields
PORT_FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
               "num_attention_heads": "n_heads",
               "num_key_value_heads": "n_kv_heads",
               "intermediate_size": "d_ff", "vocab_size": "vocab",
               "rms_norm_eps": "norm_eps",
               "tie_word_embeddings": "tie_embeddings", "remat": "remat",
               "head_size": "ssm.rwkv_head_dim"}
DECAY_LORA = 64         # the port's decay LoRA width, which it fixes

# the CPU tests' sizes
TINY = dict(hidden_size=128, attention_hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=2,
            intermediate_size=256, vocab_size=256, reference_loss_chunk=16)


def fixed(m: dict) -> dict:
    """The keys whose value the port fixes: the time-mix as wide as the
    model, and the decay LoRA's width."""
    return {"attention_hidden_size": m["hidden_size"],
            "decay_lora": DECAY_LORA}


def _axes(shape: tuple):
    """RWKV6's published per-channel ramps run over [layers, D], layer l
    at ``r = l / (layers - 1)``, channel i at ``c = i / (D - 1)``."""
    n, D = shape
    i = torch.arange(D, dtype=torch.float64)
    c = i / max(D - 1, 1)
    r = torch.arange(n, dtype=torch.float64)[:, None] / max(n - 1, 1)
    return i, c, r


def decay_ramp(shape: tuple) -> torch.Tensor:
    """The decay's ``w0``: ``-6 + 5 c ** (0.7 + 1.3 r)``."""
    i, c, r = _axes(shape)
    return -6 + 5 * c ** (0.7 + 1.3 * r)


def bonus_ramp(shape: tuple) -> torch.Tensor:
    """The bonus ``u``: ``r (1 - c) + ((i + 1) mod 3 - 1) / 10``."""
    i, c, r = _axes(shape)
    return r * (1 - c) + ((i + 1) % 3 - 1) * 0.1


def param_specs(m: dict) -> list:
    """The tree. It follows the published init where the model is
    otherwise ill-conditioned: the embedding has unit scale (the published
    model normalises it, ``ln0``, before the first block; this one does
    not), the decay's ``w0`` and the bonus ``u`` are the published
    per-channel ramps (``decay_ramp``, ``bonus_ramp``), and the
    projections that write into the residual stream (``mixer/wo``,
    ``ffn/wv``) are scaled by 1 / sqrt(2 layers). With an embedding of
    scale 1 / sqrt(vocab), every layer's RMSNorm multiplies the backward
    by the inverse of a small residual stream's scale, and through 24
    layers the gradients grow a thousandfold and turn chaotic: float32 and
    float64 gradients of the same weights differ by half."""
    D, n, V = m["hidden_size"], m["num_hidden_layers"], m["vocab_size"]
    F_ = m["intermediate_size"]
    lora = m["decay_lora"]
    out = 1 / math.sqrt(2 * n)
    top = {"embed/table": ((V, D), "normal", 1.0),
           "final_norm/scale": ((D,), "ones", 0.0),
           "unembed/w": ((D, V), "normal", 1.0 / math.sqrt(D))}
    layer = {"norm1/scale": ((D,), "ones", 0.0),
             "norm2/scale": ((D,), "ones", 0.0)}
    for k in ("wr", "wk", "wv", "wg"):
        layer[f"mixer/{k}/w"] = ((D, D), "normal", 1 / math.sqrt(D))
    layer.update({
        "mixer/wo/w": ((D, D), "normal", out / math.sqrt(D)),
        "mixer/mix/w": ((5, D), "normal", 0.1 / math.sqrt(5)),
        "mixer/w0/w": ((D,), decay_ramp, 0.0),
        "mixer/w_lora_a/w": ((D, lora), "normal", 1 / math.sqrt(D)),
        "mixer/w_lora_b/w": ((lora, D), "normal", 0.1 / math.sqrt(lora)),
        "mixer/u/w": ((D,), bonus_ramp, 0.0),
        "mixer/ln_x/scale": ((D,), "ones", 0.0),
        "ffn/mix/w": ((2, D), "normal", 0.1 / math.sqrt(2)),
        "ffn/wk/w": ((D, F_), "normal", 1 / math.sqrt(D)),
        "ffn/wv/w": ((F_, D), "normal", out / math.sqrt(F_)),
        "ffn/wr/w": ((D, D), "normal", 1 / math.sqrt(D)),
    })
    return ref.stacked_specs(top, layer, n)


def _shift(x):
    """Each position's previous token (zeros before the first)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _wkv(r, k, v, logw, u, chunk):
    """The WKV6 recurrence y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),
    S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T from S_0 = 0, in chunks:
    every decay factor is exp of a cumulative log-decay difference <= 0.
    r/k/v/logw [B, L, H, hd], u [H, hd]."""
    B, L, H, hd = r.shape
    S = torch.zeros(B, H, hd, hd, dtype=r.dtype, device=r.device)
    ys = []
    for c0 in range(0, L, chunk):
        rc, kc, vc, lw = (a[:, c0:c0 + chunk] for a in (r, k, v, logw))
        t = torch.arange(rc.shape[1], device=r.device)
        strict = (t[:, None] > t[None, :])[None, :, :, None, None]
        cum = torch.cumsum(lw, dim=1)
        prev = cum - lw
        diff = prev[:, :, None] - cum[:, None]          # [B, t, s, H, hd]
        fac = torch.exp(torch.where(strict, diff, 0.0)) * strict
        A = torch.einsum("bthd,bshd,btshd->btsh", rc, kc, fac)
        bonus = torch.einsum("bthd,bthd,hd->bth", rc, kc, u)
        y = torch.einsum("btsh,bshd->bthd", A, vc) + bonus[..., None] * vc
        y = y + torch.einsum("bthi,bhij->bthj", rc * torch.exp(prev), S)
        last = cum[:, -1]
        S = torch.exp(last)[..., None] * S + torch.einsum(
            "bshi,bshj->bhij", kc * torch.exp(last[:, None] - cum), vc)
        ys.append(y)
    return torch.cat(ys, dim=1)


def _layer(m, mm, x, n1, mix, wr, wk, wv, wg, w0, la, lb, u, lnx, wo, n2,
           cmix, cwk, cwv, cwr, rnd=ref.same):
    B, L, D = x.shape
    hd = m["head_size"]
    H = D // hd
    eps = m["rms_norm_eps"]
    h = ref.rmsnorm(x, n1, eps)
    xs = _shift(h)
    xr, xk, xv, xw, xg = (h + (xs - h) * mix[i] for i in range(5))
    r = rnd(mm(xr, wr)).view(B, L, H, hd)
    k = rnd(mm(xk, wk)).view(B, L, H, hd)
    v = rnd(mm(xv, wv)).view(B, L, H, hd)
    g = mm(xg, wg)
    raw = w0 + mm(torch.tanh(mm(xw, la)), lb)
    logw = -torch.exp(torch.clamp(raw, -8.0, 4.0)).view(B, L, H, hd)
    y = _wkv(r, k, v, logw, u.view(H, hd), m["reference_wkv_chunk"])
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(B, L, D) * lnx
    x = x + mm(y * F.silu(g), wo)
    h = ref.rmsnorm(x, n2, eps)
    xs = _shift(h)
    xk, xr = h + (xs - h) * cmix[0], h + (xs - h) * cmix[1]
    vv = mm(torch.square(F.relu(mm(xk, cwk))), cwv)
    return x + torch.sigmoid(mm(xr, cwr)) * vv


LAYER_ARGS = ("norm1/scale", "mixer/mix/w", "mixer/wr/w", "mixer/wk/w",
              "mixer/wv/w", "mixer/wg/w", "mixer/w0/w", "mixer/w_lora_a/w",
              "mixer/w_lora_b/w", "mixer/u/w", "mixer/ln_x/scale",
              "mixer/wo/w", "norm2/scale", "ffn/mix/w", "ffn/wk/w",
              "ffn/wv/w", "ffn/wr/w")


def loss_sum(m: dict, P: dict, tokens, labels, low: bool = False):
    return ref.stacked_loss_sum(m, P, tokens, labels, low, _layer,
                                LAYER_ARGS)


def matmul_params(m: dict) -> int:
    """Parameters that enter a matrix product a token: the layers' and the
    head's, not the embedding lookup."""
    D, n, V = m["hidden_size"], m["num_hidden_layers"], m["vocab_size"]
    F_ = m["intermediate_size"]
    lora = m["decay_lora"]
    return n * (6 * D * D + 2 * D * F_ + 2 * D * lora) + D * V


def mixer_forward_flops(m: dict, B: int, L: int) -> int:
    """WKV6's forward flops over B rows of L: 5·hd² a token and head."""
    hd = m["head_size"]
    return m["num_hidden_layers"] * 5 * B * L * m["hidden_size"] * hd
