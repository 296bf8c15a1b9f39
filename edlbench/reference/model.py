"""The plain reference of the benchmark's models, in plain PyTorch.

It imports nothing of the program. It holds each configuration's
parameter tree (the paths and shapes of the train state the program keeps,
so one state can be handed to both), the benchmark's own initial weights,
the two models' forward and loss in float32, and AdamW.

The models follow the repo's own model definition, which the program
implements:

* ``llama`` (Phi-3-mini): pre-norm blocks of RMSNorm, split-half RoPE,
  causal multi-head attention (grouped where kv heads < heads), a SwiGLU
  MLP, a final RMSNorm and an untied unembedding; mean cross-entropy over
  every position. Phi-3's fused qkv and gate/up matrices are kept apart,
  which is the same product; its LongRoPE scaling is not modelled.
* ``rwkv6``: pre-norm blocks of an RWKV6 time-mix (static token-shift
  mixes, a decay LoRA ``exp(-exp(clamp(w0 + tanh(x W_a) W_b, -8, 4)))``,
  the bonus ``u``, a per-head group norm, a SiLU gate) and a channel mix
  (``sigmoid(x_r W_r) * relu(x_k W_k)^2 W_v``). Departures from the
  published Finch: the token-shift mixes are static (no ddlerp LoRA), the
  norms are RMSNorm, and the group norm has a scale and no bias.

Numbers: the weights are kept in the configuration's dtype (bfloat16) as
the program keeps them, and everything is computed from their float32
values in float32 with TF32 off; the AdamW moments are float32. With
``low=True`` the activations the program keeps in bfloat16 are rounded to
float8 (e4m3, one scale per tensor) instead: every matrix product's
operands, the residual stream after each layer and the WKV6 inputs. That
is the precision below the configuration's bfloat16: the control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0         # the largest float8 e4m3 value


# ------------------------------------------------------------ the tree
def param_specs(m: dict) -> list[tuple[str, tuple, str, float]]:
    """(path, shape, init, std) of every parameter, in sorted-path order.
    Layer leaves are stacked ``[layers, ...]``; a matrix ``[d_in, d_out]``
    is drawn with std ``scale / sqrt(d_in)`` of one layer's shape.

    RWKV6 follows its published init where the model is otherwise
    ill-conditioned: the embedding has unit scale (the published model
    normalises it, ``ln0``, before the first block; this one does not),
    the decay's ``w0`` and the bonus ``u`` are the published per-channel
    ramps (``decay_ramp``, ``bonus_ramp``), and the projections that write
    into the residual stream (``mixer/wo``, ``ffn/wv``) are scaled by
    1 / sqrt(2 layers). With an embedding of scale 1 / sqrt(vocab), every
    layer's RMSNorm multiplies the backward by the inverse of a small
    residual stream's scale, and through 24 layers the gradients grow a
    thousandfold and turn chaotic: float32 and float64 gradients of the
    same weights differ by half."""
    D, n, V = m["hidden_size"], m["num_hidden_layers"], m["vocab_size"]
    F_ = m["intermediate_size"]
    specs: dict[str, tuple] = {
        "embed/table": ((V, D), "normal",
                        1.0 if m["model"] == "rwkv6" else 1.0 / math.sqrt(V)),
        "final_norm/scale": ((D,), "ones", 0.0),
        "unembed/w": ((D, V), "normal", 1.0 / math.sqrt(D)),
    }
    layer: dict[str, tuple] = {"norm1/scale": ((D,), "ones", 0.0),
                               "norm2/scale": ((D,), "ones", 0.0)}
    if m["model"] == "rwkv6":
        lora = m["decay_lora"]
        out = 1 / math.sqrt(2 * n)
        for k in ("wr", "wk", "wv", "wg"):
            layer[f"mixer/{k}/w"] = ((D, D), "normal", 1 / math.sqrt(D))
        layer.update({
            "mixer/wo/w": ((D, D), "normal", out / math.sqrt(D)),
            "mixer/mix/w": ((5, D), "normal", 0.1 / math.sqrt(5)),
            "mixer/w0/w": ((D,), "decay_ramp", 0.0),
            "mixer/w_lora_a/w": ((D, lora), "normal", 1 / math.sqrt(D)),
            "mixer/w_lora_b/w": ((lora, D), "normal", 0.1 / math.sqrt(lora)),
            "mixer/u/w": ((D,), "bonus_ramp", 0.0),
            "mixer/ln_x/scale": ((D,), "ones", 0.0),
            "ffn/mix/w": ((2, D), "normal", 0.1 / math.sqrt(2)),
            "ffn/wk/w": ((D, F_), "normal", 1 / math.sqrt(D)),
            "ffn/wv/w": ((F_, D), "normal", out / math.sqrt(F_)),
            "ffn/wr/w": ((D, D), "normal", 1 / math.sqrt(D)),
        })
    else:
        H, Hkv = m["num_attention_heads"], m["num_key_value_heads"]
        Dh = D // H
        layer.update({
            "mixer/wq/w": ((D, H * Dh), "normal", 1 / math.sqrt(D)),
            "mixer/wk/w": ((D, Hkv * Dh), "normal", 1 / math.sqrt(D)),
            "mixer/wv/w": ((D, Hkv * Dh), "normal", 1 / math.sqrt(D)),
            "mixer/wo/w": ((H * Dh, D), "normal", 1 / math.sqrt(H * Dh)),
            "ffn/wi_gate": ((D, F_), "normal", 1 / math.sqrt(D)),
            "ffn/wi_up": ((D, F_), "normal", 1 / math.sqrt(D)),
            "ffn/wo": ((F_, D), "normal", 1 / math.sqrt(F_)),
        })
    for k, (shape, init, std) in layer.items():
        specs[f"layers/slot0/{k}"] = ((n,) + shape, init, std)
    return [(k, *specs[k]) for k in sorted(specs)]


def _ramp(kind: str, shape: tuple) -> torch.Tensor:
    """RWKV6's published per-channel ramps over [layers, D], layer l at
    ``r = l / (layers - 1)``, channel i at ``c = i / (D - 1)``: the decay's
    ``-6 + 5 c ** (0.7 + 1.3 r)`` and the bonus's ``r (1 - c) + ((i + 1)
    mod 3 - 1) / 10``."""
    n, D = shape
    i = torch.arange(D, dtype=torch.float64)
    c = i / max(D - 1, 1)
    r = torch.arange(n, dtype=torch.float64)[:, None] / max(n - 1, 1)
    if kind == "decay_ramp":
        return -6 + 5 * c ** (0.7 + 1.3 * r)
    return r * (1 - c) + ((i + 1) % 3 - 1) * 0.1


def init_params(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The benchmark's initial weights, path -> tensor in ``dtype`` on
    ``device``: every normal leaf cut from one draw of a generator on that
    device seeded with ``seed``, the same values on each call."""
    specs = param_specs(m)
    total = sum(math.prod(s) for _, s, init, _ in specs if init == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for path, shape, init, std in specs:
        if init == "normal":
            n = math.prod(shape)
            out[path] = buf[off:off + n].view(shape).mul_(std)
            off += n
        elif init == "ones":
            out[path] = torch.ones(shape, dtype=dtype, device=device)
        elif init == "zeros":
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            out[path] = _ramp(init, shape).to(device=device, dtype=dtype)
    return out


# ------------------------------------------------------------ numbers
def _q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale, gradient passed
    straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def _same(x):
    return x


def matmul(low: bool):
    if low:
        return lambda a, b: torch.matmul(_q8(a), _q8(b))
    return torch.matmul


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _shift(x):
    """Each position's previous token (zeros before the first)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _rope(x, theta):
    """Split-half RoPE of x [B, H, L, Dh] at positions 0..L-1."""
    L, Dh = x.shape[-2], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float32,
                                         device=x.device) / Dh)
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :Dh // 2], x[..., Dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention_block(mm, q, k, v, c0):
    """Queries ``q`` (positions c0..) against keys and values ``k``, ``v``
    (positions 0..), causally."""
    Lq, Lk, Dh = q.shape[-2], k.shape[-2], q.shape[-1]
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(Dh)
    vis = (torch.arange(c0, c0 + Lq, device=q.device)[:, None]
           >= torch.arange(Lk, device=q.device)[None, :])
    s = s.masked_fill(~vis, float("-inf"))
    return mm(torch.softmax(s, dim=-1), v)


def _attention(q, k, v, mm, chunk):
    """Causal softmax attention, q [B, H, L, Dh], k/v [B, H, L, Dh], a
    block of ``chunk`` queries at a time against the keys up to it, each
    block's scores recomputed in the backward."""
    L = q.shape[-2]
    outs = []
    for c0 in range(0, L, chunk):
        c1 = min(L, c0 + chunk)
        outs.append(checkpoint(
            lambda a, b, c, c0=c0: _attention_block(mm, a, b, c, c0),
            q[:, :, c0:c1], k[:, :, :c1], v[:, :, :c1], use_reentrant=False))
    return torch.cat(outs, dim=2)


def _llama_layer(m, mm, x, n1, wq, wk, wv, wo, n2, wg, wu, wd, rnd=_same):
    B, L, D = x.shape
    H, Hkv = m["num_attention_heads"], m["num_key_value_heads"]
    Dh = D // H
    eps = m["rms_norm_eps"]
    h = _rmsnorm(x, n1, eps)
    q = mm(h, wq).view(B, L, H, Dh).transpose(1, 2)
    k = mm(h, wk).view(B, L, Hkv, Dh).transpose(1, 2)
    v = mm(h, wv).view(B, L, Hkv, Dh).transpose(1, 2)
    q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    o = _attention(q, k, v, mm, m["reference_attn_chunk"])
    x = x + mm(o.transpose(1, 2).reshape(B, L, D), wo)
    h = _rmsnorm(x, n2, eps)
    return x + mm(F.silu(mm(h, wg)) * mm(h, wu), wd)


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


def _rwkv6_layer(m, mm, x, n1, mix, wr, wk, wv, wg, w0, la, lb, u, lnx, wo,
                 n2, cmix, cwk, cwv, cwr, rnd=_same):
    B, L, D = x.shape
    hd = m["head_size"]
    H = D // hd
    eps = m["rms_norm_eps"]
    h = _rmsnorm(x, n1, eps)
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
    h = _rmsnorm(x, n2, eps)
    xs = _shift(h)
    xk, xr = h + (xs - h) * cmix[0], h + (xs - h) * cmix[1]
    vv = mm(torch.square(F.relu(mm(xk, cwk))), cwv)
    return x + torch.sigmoid(mm(xr, cwr)) * vv


LAYER_ARGS = {
    "llama": ("norm1/scale", "mixer/wq/w", "mixer/wk/w", "mixer/wv/w",
              "mixer/wo/w", "norm2/scale", "ffn/wi_gate", "ffn/wi_up",
              "ffn/wo"),
    "rwkv6": ("norm1/scale", "mixer/mix/w", "mixer/wr/w", "mixer/wk/w",
              "mixer/wv/w", "mixer/wg/w", "mixer/w0/w", "mixer/w_lora_a/w",
              "mixer/w_lora_b/w", "mixer/u/w", "mixer/ln_x/scale",
              "mixer/wo/w", "norm2/scale", "ffn/mix/w", "ffn/wk/w",
              "ffn/wv/w", "ffn/wr/w"),
}
LAYERS = {"llama": _llama_layer, "rwkv6": _rwkv6_layer}


def _xent_chunk(mm, x, w, labels):
    logits = mm(x, w)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def loss_sum(m: dict, P: dict, tokens, labels, low: bool = False):
    """The summed cross-entropy over every position of ``tokens`` [B, L]
    (labels the next tokens), from float32 params ``P`` (path -> tensor;
    a layer leaf as a list of its layers' tensors). Each layer, and each
    block of the loss, is recomputed in the backward."""
    mm = matmul(low)
    rnd = _q8 if low else _same
    fn = LAYERS[m["model"]]
    x = rnd(P["embed/table"][tokens])
    args = [P[f"layers/slot0/{k}"] for k in LAYER_ARGS[m["model"]]]
    for i in range(m["num_hidden_layers"]):
        x = rnd(checkpoint(lambda x_, *a: fn(m, mm, x_, *a, rnd=rnd), x,
                           *(a[i] for a in args), use_reentrant=False))
    x = _rmsnorm(x, P["final_norm/scale"], m["rms_norm_eps"])
    total = x.new_zeros(())
    C = m["reference_loss_chunk"]
    for c0 in range(0, x.shape[1], C):
        total = total + checkpoint(
            lambda a, b, c: _xent_chunk(mm, a, b, c), x[:, c0:c0 + C],
            P["unembed/w"], labels[:, c0:c0 + C], use_reentrant=False)
    return total


# ------------------------------------------------------------ training
def _split_layers(tree: dict) -> dict:
    """path -> tensor, or for a layer leaf a list of its layers' tensors."""
    return {k: (list(t.unbind(0)) if k.startswith("layers/") else t)
            for k, t in tree.items()}


def _pieces(tree: dict):
    for k, t in tree.items():
        for i, x in enumerate(t if isinstance(t, list) else [t]):
            yield (k, i), x


def _norms(sq: dict) -> dict:
    return {k: math.sqrt(v) for k, v in sq.items()}


def train(m: dict, opt: dict, seed: int, batches, devices, *,
          low: bool = False, rows: int = 1) -> dict:
    """The reference's training from the benchmark's initial weights over
    ``batches`` (a list of (tokens, labels) int64 CPU tensors, one global
    batch a step), AdamW as ``opt`` states it.

    The rows of a batch are split evenly over ``devices``, each holding a
    float32 copy of the weights and computing its rows' gradient ``rows``
    at a time; the gradients are summed on the first device, which keeps
    the bfloat16 weights and the float32 moments. Returns the mean loss of
    each step, the first step's gradient norm of each leaf, and each
    leaf's change after the last step; norms are float64 over the layers
    of a stacked leaf."""
    home = torch.device(devices[0])
    master = _split_layers(init_params(m, seed, home))
    start = {k: [x.clone() for x in v] if isinstance(v, list) else v.clone()
             for k, v in master.items()}
    mu = {key: torch.zeros_like(x, dtype=torch.float32)
          for key, x in _pieces(master)}
    nu = {key: torch.zeros_like(x, dtype=torch.float32)
          for key, x in _pieces(master)}
    b1, b2, eps, lr, wd = (opt["b1"], opt["b2"], opt["eps"], opt["lr"],
                           opt["weight_decay"])
    out = {"loss": [], "grad_norm": {}, "change_norm": {}}
    for step, (tokens, labels) in enumerate(batches, 1):
        n_tok = tokens.numel()
        per = tokens.shape[0] // len(devices)
        # every device's float32 copy first: a copy from the first device
        # waits for the work queued there, so copying between the devices'
        # backwards would run them one after another
        reps = [{k: ([x.to(dev).float().requires_grad_() for x in v]
                     if isinstance(v, list)
                     else v.to(dev).float().requires_grad_())
                 for k, v in master.items()} for dev in devices]
        parts = []
        for d, (dev, P) in enumerate(zip(devices, reps)):
            for r0 in range(d * per, (d + 1) * per, rows):
                r1 = min(r0 + rows, (d + 1) * per)
                part = loss_sum(m, P, tokens[r0:r1].to(dev),
                                labels[r0:r1].to(dev), low) / n_tok
                part.backward()
                parts.append(part.detach())
        out["loss"].append(float(sum(p.to(home) for p in parts)))
        grads = {}
        for key, _ in _pieces(master):
            g = None
            for P in reps:
                t = P[key[0]]
                t = t[key[1]] if isinstance(t, list) else t
                g = t.grad.to(home) if g is None else g + t.grad.to(home)
            grads[key] = g
        del reps
        if step == 1:
            sq: dict = {}
            for (k, _), g in grads.items():
                sq[k] = sq.get(k, 0.0) + float(g.double().square().sum())
            out["grad_norm"] = _norms(sq)
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** step
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** step
        with torch.no_grad():
            for key, p in list(_pieces(master)):
                g = grads.pop(key)
                mu[key] = b1 * mu[key] + (1 - b1) * g
                nu[key] = b2 * nu[key] + (1 - b2) * g.square()
                upd = lr * (mu[key] / bc1.item()) / (
                    torch.sqrt(nu[key] / bc2.item()) + eps)
                upd = upd + lr * wd * p.float()
                new = (p.float() - upd).to(p.dtype)
                k, i = key
                if isinstance(master[k], list):
                    master[k][i] = new
                else:
                    master[k] = new
    sq = {}
    for (k, i), p in _pieces(master):
        p0 = start[k][i] if isinstance(start[k], list) else start[k]
        sq[k] = sq.get(k, 0.0) + float(
            (p.double() - p0.double()).square().sum())
    out["change_norm"] = _norms(sq)
    return out
