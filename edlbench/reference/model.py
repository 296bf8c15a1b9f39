"""What the plain reference of every model kind shares, in plain PyTorch.

It imports nothing of the program. The kind of a configuration (its
``"model"`` key) has a module of its own, ``reference/<model>.py``
(``edlbench.reference.kind``), which holds its parameter tree (the paths
and shapes of the train state the program keeps, so one state can be
handed to both), its forward and loss in float32, and its counts. This
module holds the rest: the benchmark's initial weights drawn from a
kind's tree, float8 rounding, RMSNorm, RoPE, chunked causal attention,
the chunked cross-entropy, a stack of layers under that loss, and AdamW
training; ``param_specs`` and ``loss_sum`` dispatch to the kind.

Numbers: the weights are kept in the configuration's dtype (bfloat16) as
the program keeps them, and everything is computed from their float32
values in float32 with TF32 off; the AdamW moments are float32. With
``low=True`` the activations the program keeps in bfloat16 are rounded to
float8 (e4m3, one scale per tensor) instead: every matrix product's
operands, the residual stream after each layer, and what else a kind
rounds. That is the precision below the configuration's bfloat16: the
control.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from edlbench.reference import kind

FP8_MAX = 448.0         # the largest float8 e4m3 value
LAYERS = "layers/slot0/"


# ------------------------------------------------------------ the tree
def param_specs(m: dict) -> list[tuple[str, tuple, object, float]]:
    """(path, shape, init, std) of every parameter of the configuration's
    kind, in sorted-path order. ``init`` is ``"normal"`` (drawn with std
    ``std``), ``"ones"``, ``"zeros"``, or a function of the shape giving
    the float64 values."""
    return kind(m).param_specs(m)


def stacked_specs(top: dict, layer: dict, n: int) -> list:
    """``param_specs``' list of a tree of ``top`` leaves and ``n`` layers
    of ``layer`` leaves, each stacked ``[n, ...]`` under ``LAYERS``
    (path -> (shape, init, std) in both)."""
    specs = dict(top)
    for k, (shape, init, std) in layer.items():
        specs[f"{LAYERS}{k}"] = ((n,) + shape, init, std)
    return [(k, *specs[k]) for k in sorted(specs)]


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
            out[path] = init(shape).to(device=device, dtype=dtype)
    return out


# ------------------------------------------------------------ numbers
def q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale, gradient passed
    straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def same(x):
    return x


def matmul(low: bool):
    if low:
        return lambda a, b: torch.matmul(q8(a), q8(b))
    return torch.matmul


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
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


def attention(q, k, v, mm, chunk):
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


def _xent_chunk(mm, x, w, labels):
    logits = mm(x, w)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def loss_sum(m: dict, P: dict, tokens, labels, low: bool = False):
    """The summed cross-entropy over every position of ``tokens`` [B, L]
    (labels the next tokens), from float32 params ``P`` (path -> tensor;
    a layer leaf as a list of its layers' tensors), by the configuration's
    kind; ``low``: the float8 control."""
    return kind(m).loss_sum(m, P, tokens, labels, low)


def stacked_loss_sum(m: dict, P: dict, tokens, labels, low: bool, layer,
                     args: tuple):
    """``loss_sum`` of a stack of ``num_hidden_layers`` layers between the
    embedding and a final RMSNorm and unembedding: ``layer(m, mm, x,
    *leaves, rnd=rnd)`` with the leaves ``args`` (paths under ``LAYERS``)
    of its layer. Each layer, and each block of the loss, is recomputed in
    the backward."""
    mm = matmul(low)
    rnd = q8 if low else same
    x = rnd(P["embed/table"][tokens])
    leaves = [P[f"{LAYERS}{k}"] for k in args]
    for i in range(m["num_hidden_layers"]):
        x = rnd(checkpoint(lambda x_, *a: layer(m, mm, x_, *a, rnd=rnd), x,
                           *(a[i] for a in leaves), use_reentrant=False))
    x = rmsnorm(x, P["final_norm/scale"], m["rms_norm_eps"])
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
