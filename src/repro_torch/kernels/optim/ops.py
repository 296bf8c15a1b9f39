"""AdamW and the gradient norm: the hand-written CUDA kernels, their plain
PyTorch versions, and the wrappers the optimizer and the step call.

The kernels (``kernels/csrc/adamw.cu``) replace no TPU kernel: the
reference's update is plain jnp, which XLA fuses into one loop a leaf.
``adamw_update`` (the function) is one leaf's Adam/AdamW update for
``optim/optimizers.py: adam``; on the card it launches the kernel of the
same name, one pass over the leaf with the bits of the eager formula
(``adamw_update_plain``) there. ``sq_sum`` is the gradient norm's sum of
squares over a list of leaves for ``training/step.py: apply_update``; on
the card it launches ``grad_sq_sum`` a leaf and ``grad_sq_sum_final`` a
device, a fixed-order two-stage sum with no atomics, so two runs give the
same bits; its order is not the eager one's (the norm is diagnostic
only).

Which path a call takes is a rule by device, not a fallback: a CUDA
tensor launches the kernels, or the call raises; a tensor on the CPU goes
to the plain versions; on ``meta`` (the dry-run) the wrapper applies the
CUDA path's checks and returns empty ``meta`` tensors of the kernels'
output shapes. Each launch adds one to the port's launch count
(``kernels/launches.py``), and every call adds its kernels' bytes to
``COSTS`` (no flops: the kernels are bound by bytes, and
``FlopCounterMode`` counts no elementwise op either; the final sum's few
kilobytes of partials are left out).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import COSTS, FAMILIES, LAUNCHES, \
    RefusedType

KERNELS = FAMILIES["optim"]
_CUDA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NT, VEC = 256, 8                        # adamw.cu's block and step
# the grids' caps, blocks an SM: the fastest over phi3-mini-16l's tree
# (adamw.cu's design note)
UPDATE_BLOCKS_PER_SM, SUM_BLOCKS_PER_SM = 2, 8


# ------------------------------------------------------------ plain versions
def adamw_update_plain(p, g, m, v, bc1, bc2, *, lr: float, b1: float,
                       b2: float, eps: float, weight_decay: float):
    """The reference's Adam/AdamW update of one leaf, written eagerly in
    fp32: the moments and the step from ``g`` (``p``'s leaf of the
    gradients), with the bias corrections ``bc1`` and ``bc2`` (0-d fp32).
    Returns (p', m', v'), p' in ``p``'s dtype."""
    g32 = g.float()
    m = b1 * m + (1 - b1) * g32
    v = b2 * v + (1 - b2) * g32.square()
    step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if weight_decay:
        step = step + lr * weight_decay * p.float()
    return (p.float() - step).to(p.dtype), m, v


def sq_sum_plain(tensors, home) -> torch.Tensor:
    """The sum of the squares of every element of ``tensors``, leaf by
    leaf in fp32, on ``home``."""
    total = torch.zeros((), device=home)
    for t in tensors:
        total = total + t.float().square().sum().to(home)
    return total


# ------------------------------------------------------------ CUDA kernels
_SIGNATURES = {
    # p, g, m, v, p_out, m_out, v_out; n, n_vec; blocks; bc1, bc2; b1,
    # 1 - b1, b2, 1 - b2, lr, eps, lr * wd; decay, dtype; stream
    "adamw_update": [ctypes.c_void_p] * 7
    + [ctypes.c_longlong] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_float] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    # x; n, n_vec; blocks; partial; dtype; stream
    "grad_sq_sum": [ctypes.c_void_p] + [ctypes.c_longlong] * 2
    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    # partial; n; out; stream
    "grad_sq_sum_final": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p],
}


def _lib() -> ctypes.CDLL:
    lib = build.load("adamw")
    if not getattr(lib, "_typed", False):
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.adamw_error_string.argtypes = [ctypes.c_int]
        lib.adamw_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(name: str, device: torch.device, *args):
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.adamw_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")
    LAUNCHES.add(name)


def launch_shape(n: int, tensors, cap: int) -> tuple[int, int]:
    """(n_vec, blocks) of a launch over ``n`` elements of ``tensors``: the
    elements taken 8 at a time (all but the last n % 8, or none where a
    tensor does not start on a 16-byte boundary) and the grid, one thread
    a step of 8 or a lone element, at most ``cap`` blocks."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    n_vec = n - n % VEC if aligned else 0
    units = n_vec // VEC + (n - n_vec)
    return n_vec, max(1, min(cap, -(-units // NT)))


def adamw_update_cuda(p, g, m, v, bc1, bc2, *, lr: float, b1: float,
                      b2: float, eps: float, weight_decay: float):
    """Launch ``adamw_update`` on one leaf. Returns (p', m', v'), new
    contiguous tensors; the inputs are left as they are."""
    p, g, m, v = (t.contiguous() for t in (p, g, m, v))
    outs = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
    n = p.numel()
    if n:
        ts = (p, g, m, v, *outs)
        sms = torch.cuda.get_device_properties(p.device).multi_processor_count
        n_vec, blocks = launch_shape(n, ts, UPDATE_BLOCKS_PER_SM * sms)
        _launch("adamw_update", p.device, *(t.data_ptr() for t in ts), n,
                n_vec, blocks, bc1.data_ptr(), bc2.data_ptr(), b1, 1 - b1, b2,
                1 - b2, lr, eps, lr * weight_decay, int(bool(weight_decay)),
                _CUDA_DTYPES[p.dtype])
    return outs


def sq_sum_cuda(tensors, device: torch.device) -> torch.Tensor:
    """Launch ``grad_sq_sum`` on each of ``tensors`` (all on ``device``),
    each into its slice of the partials, then ``grad_sq_sum_final`` over
    them. Returns a 0-d fp32 tensor on ``device``."""
    xs = [t.contiguous() for t in tensors if t.numel()]
    if not xs:
        return torch.zeros((), device=device)
    cap = SUM_BLOCKS_PER_SM * torch.cuda.get_device_properties(
        device).multi_processor_count
    plans = [launch_shape(x.numel(), (x,), cap) for x in xs]
    partial = torch.empty(sum(b for _, b in plans), dtype=torch.float32,
                          device=device)
    out = torch.empty((), dtype=torch.float32, device=device)
    at = 0
    for x, (n_vec, blocks) in zip(xs, plans):
        _launch("grad_sq_sum", device, x.data_ptr(), x.numel(), n_vec, blocks,
                partial.data_ptr() + 4 * at, _CUDA_DTYPES[x.dtype])
        at += blocks
    _launch("grad_sq_sum_final", device, partial.data_ptr(), at,
            out.data_ptr())
    return out


# ------------------------------------------------------------------ costs
def update_bytes(p) -> int:
    """Bytes ``adamw_update`` moves on one leaf: p and g read, p' written
    (in their dtype), m and v read and m' and v' written in fp32: 22 a
    parameter in bf16, 28 in fp32."""
    return p.numel() * (3 * p.element_size() + 16)


# ---------------------------------------------------------------- wrappers
def _check_cuda_dtype(t, what: str):
    if t.dtype not in _CUDA_DTYPES:
        raise RefusedType(f"the CUDA optimizer kernels take float32 or "
                          f"bfloat16 {what}, not {t.dtype}")


def _check_update(p, g, m, v, bc1, bc2):
    ts = (p, g, m, v, bc1, bc2)
    if not p.shape == g.shape == m.shape == v.shape:
        raise ValueError(f"param {tuple(p.shape)}, gradient "
                         f"{tuple(g.shape)} and moments {tuple(m.shape)}, "
                         f"{tuple(v.shape)} differ")
    if len({t.device for t in ts}) != 1:
        raise ValueError("the update's inputs must be on one device")
    if p.is_cuda or p.is_meta:      # meta: the dry-run holds the CUDA path
        _check_cuda_dtype(p, "params")
        if g.dtype != p.dtype:
            raise RefusedType(f"the CUDA optimizer kernels take a gradient "
                              f"of its param's dtype, not {g.dtype} for "
                              f"{p.dtype}")
        if {m.dtype, v.dtype, bc1.dtype, bc2.dtype} != {torch.float32}:
            raise RefusedType(f"the CUDA optimizer kernels take float32 "
                              f"moments and bias corrections, not "
                              f"{m.dtype}, {v.dtype}, {bc1.dtype}, "
                              f"{bc2.dtype}")
        if bc1.numel() != 1 or bc2.numel() != 1:
            raise ValueError("the bias corrections must be scalars")
    elif p.device.type != "cpu":
        raise ValueError(f"unsupported device {p.device}")


def adamw_update(p, g, m, v, bc1, bc2, *, lr: float, b1: float, b2: float,
                 eps: float, weight_decay: float):
    """One leaf's Adam/AdamW update: ``p`` and its gradient ``g``, the
    moments ``m`` and ``v`` (fp32), the bias corrections ``bc1`` and
    ``bc2`` (0-d fp32 on ``p``'s device). Returns (p', m', v') without
    touching the inputs: the kernel on the card, the plain version on the
    CPU, empty tensors of the kernel's outputs on ``meta``."""
    _check_update(p, g, m, v, bc1, bc2)
    COSTS.add("adamw_update", 0, update_bytes(p), where=p)
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if p.is_cuda:
        return adamw_update_cuda(p, g, m, v, bc1, bc2, **hyper)
    if p.is_meta:
        return torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)
    return adamw_update_plain(p, g, m, v, bc1, bc2, **hyper)


def sq_sum(tensors, home) -> torch.Tensor:
    """The sum of the squares of every element of ``tensors`` (the
    gradient norm's square), a 0-d fp32 tensor on ``home``: each device's
    leaves summed by the kernels on the card, by the plain version on the
    CPU, and the devices' sums added in the order of their first leaves."""
    by_device: dict[torch.device, list] = {}
    for t in tensors:
        if t.is_cuda or t.is_meta:
            _check_cuda_dtype(t, "gradients")
            COSTS.add("grad_sq_sum", 0, t.numel() * t.element_size(),
                      where=t)
        by_device.setdefault(t.device, []).append(t)
    parts = []
    for device, ts in by_device.items():
        if device.type == "cuda":
            parts.append(sq_sum_cuda(ts, device))
        elif device.type == "meta":
            parts.append(torch.empty((), device=device))
        else:
            parts.append(sq_sum_plain(ts, device))
    if not parts:
        return torch.zeros((), device=home)
    total = parts[0].to(home)
    for part in parts[1:]:
        total = total + part.to(home)
    return total
