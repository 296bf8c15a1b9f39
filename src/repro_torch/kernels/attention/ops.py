"""Flash attention: the hand-written CUDA kernels, their plain PyTorch
versions, and the differentiable wrapper the model calls.

Counterpart of ``repro/kernels/attention/{kernel,ops,ref}.py``. The kernels
take CUDA tensors; a tensor on the CPU goes to the plain versions in this
module, which follow the reference's ``attention_ref`` (including
``kv_len``) and write out the backward's formulas. A CUDA tensor never
reaches a plain version: it launches the kernel, or the call raises.

Which kernel a CUDA call launches is a rule by dtype (``kernel_names``),
not a fallback: float32 goes to the CUDA-core kernels of
``kernels/csrc/flash_attn.cu`` (``flash_attn_fwd``, ``flash_attn_bwd_dq``,
``flash_attn_bwd_dkdv``), bfloat16 to the tensor-core kernels of
``kernels/csrc/flash_attn_tc.cu`` (``flash_attn_fwd_tc``,
``flash_attn_bwd_dq_tc``, ``flash_attn_bwd_dkdv_tc``). In both the dQ
kernel runs first and writes the delta that dK/dV reads. The tensor-core
kernels load 16-byte chunks, so their wrappers copy any bf16 input that
does not start on a 16-byte boundary to a fresh (aligned) tensor first.

Each kernel wrapper adds one to the port's launch count
(``kernels/launches.py``) where it launches, so a run can show that its
path went through the kernels. On ``meta`` tensors (the dry-run) the
wrapper applies the CUDA path's checks and returns empty ``meta`` tensors
of the kernels' output shapes, forward and backward, and never runs a
plain version. Every call adds its kernels' work to ``COSTS``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import COSTS, FAMILIES, LAUNCHES, \
    RefusedType, RefusedValue

NEG_INF = -1e30
KERNELS = FAMILIES["attention"]
CUDA_HEAD_DIMS = (16, 32, 64, 96, 128)
_CUDA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CPU_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


# ------------------------------------------------------------ plain versions
def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _mask(Lq: int, Lk: int, causal: bool, window: int, kv_len: int, device
          ) -> torch.Tensor:
    q_pos = torch.arange(Lq, device=device)[:, None]
    k_pos = torch.arange(Lk, device=device)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window > 0:
        mask = mask & ((q_pos - k_pos) < window)
    return mask


def _grouped(q, k, v):
    """[B,Hq,Lq,D] q and [B,Hkv,Lk,D] k/v as [B,Hkv,G,Lq,D] / [B,Hkv,Lk,D]
    in the compute dtype."""
    B, Hq, Lq, D = q.shape
    Hkv = k.shape[1]
    ct = _compute_dtype(q.dtype)
    return (q.to(ct).reshape(B, Hkv, Hq // Hkv, Lq, D), k.to(ct), v.to(ct))


def _scores(qg, kc, causal, window, scale, kv_len):
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kc) * scale
    mask = _mask(qg.shape[3], kc.shape[2], causal, window, kv_len, qg.device)
    return torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype,
                                           device=s.device))


def flash_attn_fwd_plain(q, k, v, *, causal: bool = True, window: int = 0,
                         scale: float | None = None, kv_len: int | None = None):
    """Full-matrix masked softmax attention, as ``ref.py: attention_ref``.
    q: [B,Hq,Lq,D]; k/v: [B,Hkv,Lk,D]. Returns (o [B,Hq,Lq,D] in q's dtype,
    lse [B,Hq,Lq] in fp32, fp64 for fp64 inputs)."""
    B, Hq, Lq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    kv_len = k.shape[2] if kv_len is None else kv_len
    qg, kc, vc = _grouped(q, k, v)
    s = _scores(qg, kc, causal, window, scale, kv_len)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vc) / l.clamp_min(1e-30)
    lse = (m + torch.log(l)).reshape(B, Hq, Lq)
    return o.reshape(B, Hq, Lq, D).to(q.dtype), lse


def _probs_and_dp(q, k, v, lse, do, causal, window, scale, kv_len):
    """Recomputed P = exp(s - lse) and dP = dO V^T, [B,Hkv,G,Lq,Lk], with
    q and dO grouped as [B,Hkv,G,Lq,D] and k/v in the compute dtype."""
    qg, kc, vc = _grouped(q, k, v)
    dog = do.to(qg.dtype).reshape(qg.shape)
    s = _scores(qg, kc, causal, window, scale, kv_len)
    p = torch.exp(s - lse.to(qg.dtype).reshape(qg.shape[:-1])[..., None])
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vc)
    return qg, kc, dog, p, dp


def flash_attn_bwd_dq_plain(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, scale: float | None = None,
                            kv_len: int | None = None):
    """What ``flash_attn_bwd_dq`` computes: delta = rowsum(dO * O),
    dS = P (dP - delta), dQ = scale dS K. Returns (dq in q's dtype,
    delta [B,Hq,Lq] in the compute dtype)."""
    B, Hq, Lq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    kv_len = k.shape[2] if kv_len is None else kv_len
    qg, kc, dog, p, dp = _probs_and_dp(q, k, v, lse, do, causal, window,
                                       scale, kv_len)
    delta = (dog * o.to(qg.dtype).reshape(qg.shape)).sum(dim=-1)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", p * (dp - delta[..., None]),
                      kc) * scale
    return dq.reshape(B, Hq, Lq, D).to(q.dtype), delta.reshape(B, Hq, Lq)


def flash_attn_bwd_dkdv_plain(q, k, v, lse, delta, do, *, causal: bool = True,
                              window: int = 0, scale: float | None = None,
                              kv_len: int | None = None):
    """What ``flash_attn_bwd_dkdv`` computes: dV = P^T dO and
    dK = scale dS^T Q, summed over the G q heads of each kv head. Returns
    (dk, dv) in k's and v's dtypes."""
    D = q.shape[-1]
    scale = D ** -0.5 if scale is None else scale
    kv_len = k.shape[2] if kv_len is None else kv_len
    qg, _, dog, p, dp = _probs_and_dp(q, k, v, lse, do, causal, window,
                                      scale, kv_len)
    dl = delta.to(qg.dtype).reshape(qg.shape[:-1])[..., None]
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", p * (dp - dl), qg) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attn_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                         window: int = 0, scale: float | None = None,
                         kv_len: int | None = None):
    """The backward the kernels compute, written out: P = exp(s - lse),
    dV = P^T dO, dP = dO V^T, delta = rowsum(dO * O), dS = P (dP - delta),
    dQ = scale dS K, dK = scale dS^T Q, with dK/dV summed over the G q
    heads of each kv head. Returns (dq, dk, dv) in the inputs' dtypes."""
    opts = dict(causal=causal, window=window, scale=scale, kv_len=kv_len)
    dq, delta = flash_attn_bwd_dq_plain(q, k, v, o, lse, do, **opts)
    dk, dv = flash_attn_bwd_dkdv_plain(q, k, v, lse, delta, do, **opts)
    return dq, dk, dv


# ------------------------------------------------------------ CUDA kernels
def kernel_names(dtype: torch.dtype) -> tuple[str, str, str]:
    """The kernels that compute the forward, dQ and dK/dV of inputs of
    ``dtype`` on the card (and whose work ``COSTS`` books on ``meta``)."""
    if dtype == torch.bfloat16:
        return ("flash_attn_fwd_tc", "flash_attn_bwd_dq_tc",
                "flash_attn_bwd_dkdv_tc")
    return "flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkdv"


_SIGNATURES = {
    # q, k, v, o, lse; B, Hq, Hkv, Lq, Lk, D, kv_len, causal, window; scale;
    # dtype; stream
    "flash_attn_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    # q, k, v, o, dout, lse, dq, delta; ints; scale; dtype; stream
    "flash_attn_bwd_dq": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    # q, k, v, dout, lse, delta, dk, dv; ints; scale; dtype; stream
    "flash_attn_bwd_dkdv": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
# csrc/flash_attn_tc.cu: the same interfaces, bf16 only
TC_SIGNATURES = {"flash_attn_fwd_tc": _SIGNATURES["flash_attn_fwd"],
                 "flash_attn_bwd_dq_tc": _SIGNATURES["flash_attn_bwd_dq"],
                 "flash_attn_bwd_dkdv_tc": _SIGNATURES["flash_attn_bwd_dkdv"]}
_LIBRARIES = {"flash_attn": _SIGNATURES, "flash_attn_tc": TC_SIGNATURES}


def _lib(source: str) -> ctypes.CDLL:
    lib = build.load(source)
    if not getattr(lib, "_typed", False):
        for name, argtypes in _LIBRARIES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err_string = getattr(lib, f"{source}_error_string")
        err_string.argtypes = [ctypes.c_int]
        err_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(name: str, device: torch.device, ptrs, ints, scale: float,
            dtype: torch.dtype):
    source = "flash_attn_tc" if name in TC_SIGNATURES else "flash_attn"
    lib = _lib(source)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*ptrs, *ints, float(scale),
                                 _CUDA_DTYPES[dtype], stream)
    if err != 0:
        msg = getattr(lib, f"{source}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")
    LAUNCHES.add(name)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its data starts on a 16-byte boundary, else a contiguous
    copy of it (a fresh allocation, which does): the tensor-core kernels'
    16-byte loads need that."""
    return t if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format)


def _dims(q, k, kv_len, causal, window):
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    return [B, Hq, Hkv, Lq, Lk, D, kv_len, int(causal), window]


def flash_attn_fwd_cuda(q, k, v, *, causal, window, scale, kv_len):
    """Launch the forward of ``kernel_names(q.dtype)``: ``flash_attn_fwd``
    (fp32) or ``flash_attn_fwd_tc`` (bf16). Returns (o, lse)."""
    B, Hq, Lq, _ = q.shape
    name = kernel_names(q.dtype)[0]
    if name in TC_SIGNATURES:
        q, k, v = aligned16(q), aligned16(k), aligned16(v)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    _launch(name, q.device,
            [t.data_ptr() for t in (q, k, v, o, lse)],
            _dims(q, k, kv_len, causal, window), scale, q.dtype)
    return o, lse


def flash_attn_bwd_dq_cuda(q, k, v, o, lse, do, *, causal, window, scale,
                           kv_len):
    """Launch the dQ kernel of ``kernel_names(q.dtype)``:
    ``flash_attn_bwd_dq`` (fp32) or ``flash_attn_bwd_dq_tc`` (bf16).
    Returns (dq, delta)."""
    B, Hq, Lq, _ = q.shape
    name = kernel_names(q.dtype)[1]
    if name in TC_SIGNATURES:
        q, k, v, o, do = (aligned16(t) for t in (q, k, v, o, do))
    dq = torch.empty_like(q)
    delta = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    _launch(name, q.device,
            [t.data_ptr() for t in (q, k, v, o, do, lse, dq, delta)],
            _dims(q, k, kv_len, causal, window), scale, q.dtype)
    return dq, delta


def flash_attn_bwd_dkdv_cuda(q, k, v, lse, delta, do, *, causal, window,
                             scale, kv_len):
    """Launch the dK/dV kernel of ``kernel_names(q.dtype)``:
    ``flash_attn_bwd_dkdv`` (fp32) or ``flash_attn_bwd_dkdv_tc`` (bf16).
    Returns (dk, dv)."""
    name = kernel_names(q.dtype)[2]
    if name in TC_SIGNATURES:
        q, k, v, do = (aligned16(t) for t in (q, k, v, do))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(name, q.device,
            [t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)],
            _dims(q, k, kv_len, causal, window), scale, q.dtype)
    return dk, dv


def flash_attn_bwd_cuda(q, k, v, o, lse, do, **opts):
    """The dQ kernel of ``kernel_names(q.dtype)`` (which also writes
    delta), then its dK/dV kernel on the same stream. Returns (dq, dk,
    dv)."""
    dq, delta = flash_attn_bwd_dq_cuda(q, k, v, o, lse, do, **opts)
    dk, dv = flash_attn_bwd_dkdv_cuda(q, k, v, lse, delta, do, **opts)
    return dq, dk, dv


# ------------------------------------------------------------------ costs
def visible_pairs(Lq: int, Lk: int, causal: bool, window: int,
                  kv_len: int) -> int:
    """The (query, key) pairs the mask lets through, for one head of one
    sequence: key k is visible to query i where k < kv_len, k <= i
    (causal) and i - k < window (window > 0)."""
    q = np.arange(Lq, dtype=np.int64)
    hi = np.full(Lq, min(Lk, kv_len), dtype=np.int64)
    if causal:
        hi = np.minimum(hi, q + 1)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros_like(q)
    return int(np.maximum(hi - lo, 0).sum())


def flash_work(q, k, causal: bool, window: int, kv_len: int
               ) -> dict[str, tuple[int, int]]:
    """(flops, bytes) each flash kernel does on these inputs: the bounds'
    formulas (``chip_smoke.py`` phase 3). A tensor-core kernel does the
    work of the kernel it stands in for."""
    B, Hq, Lq, D = q.shape
    Lk = k.shape[2]
    esz = q.element_size()
    n_qo = B * Hq * Lq * D * esz
    n_kv = B * k.shape[1] * Lk * D * esz
    n_row = B * Hq * Lq * 4
    pairs = B * Hq * visible_pairs(Lq, Lk, causal, window, kv_len)
    fwd = (4 * D * pairs, 2 * n_qo + 2 * n_kv + n_row)
    dq = (6 * D * pairs, 4 * n_qo + 2 * n_kv + 2 * n_row)
    dkdv = (8 * D * pairs, 2 * n_qo + 4 * n_kv + 2 * n_row)
    return {"flash_attn_fwd": fwd, "flash_attn_fwd_tc": fwd,
            "flash_attn_bwd_dq": dq, "flash_attn_bwd_dq_tc": dq,
            "flash_attn_bwd_dkdv": dkdv, "flash_attn_bwd_dkdv_tc": dkdv}


def _count(q, k, opts: dict, names):
    work = flash_work(q, k, opts["causal"], opts["window"], opts["kv_len"])
    for name in names:
        COSTS.add(name, *work[name], where=q)


# ---------------------------------------------------------------- wrapper
def _check(q, k, v, window: int, kv_len: int):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes q [B,Hq,Lq,D] and k/v "
                         "[B,Hkv,Lk,D]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    B, Hq, Lq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match in batch or head dim")
    if Hq % k.shape[1]:
        raise ValueError(f"{Hq} q heads do not group over {k.shape[1]} kv heads")
    if not 0 < kv_len <= k.shape[2] or window < 0 or Lq < 1:
        raise ValueError(f"bad kv_len {kv_len}, window {window} or Lq {Lq}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must be on one device")
    if len({q.dtype, k.dtype, v.dtype}) != 1:
        raise ValueError("q, k and v must have one dtype")
    if q.is_cuda or q.is_meta:      # meta: the dry-run holds the CUDA path
        if q.dtype not in _CUDA_DTYPES:
            raise RefusedType(f"the CUDA kernels take float32 or bfloat16, "
                              f"not {q.dtype}")
        if D not in CUDA_HEAD_DIMS:
            raise RefusedValue(f"the CUDA kernels take head_dim in "
                               f"{CUDA_HEAD_DIMS}, not {D}")
        # the kernels' element offsets are 64-bit, so a tensor may pass
        # 2**31 elements; the grid is (B H, tiles of 64 rows), whose y
        # extent CUDA caps at 65535
        if B * Hq >= 2 ** 31 or max(Lq, k.shape[2]) > 65535 * 64:
            raise RefusedValue(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                               f"exceed the kernels' grid: B H < 2**31 and "
                               f"L <= {65535 * 64}")
    elif q.device.type == "cpu":
        if q.dtype not in _CPU_DTYPES:
            raise TypeError(f"unsupported dtype {q.dtype}")
    else:
        raise ValueError(f"unsupported device {q.device}")


class FlashAttnFn(torch.autograd.Function):
    """Flash attention with its own backward. Saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, kv_len):
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        kv_len=kv_len)
        _count(q, k, ctx.opts, kernel_names(q.dtype)[:1])
        if q.is_cuda:
            o, lse = flash_attn_fwd_cuda(q, k, v, **ctx.opts)
        elif q.is_meta:
            o = torch.empty_like(q)
            lse = q.new_empty(q.shape[:3], dtype=torch.float32)
        else:
            o, lse = flash_attn_fwd_plain(q, k, v, **ctx.opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.warming = LAUNCHES.is_warming()
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        _count(q, k, ctx.opts, kernel_names(q.dtype)[1:])
        if q.is_cuda:
            with LAUNCHES.warming(ctx.warming):
                dq, dk, dv = flash_attn_bwd_cuda(q, k, v, o, lse, do,
                                                 **ctx.opts)
        elif q.is_meta:
            # dq and delta, then dk and dv, as the kernels write them
            dq, delta = torch.empty_like(q), torch.empty_like(lse)
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            del delta
        else:
            dq, dk, dv = flash_attn_bwd_plain(q, k, v, o, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention_bhld(q, k, v, *, causal: bool = True, window: int = 0,
                         scale: float | None = None,
                         kv_len: int | None = None) -> torch.Tensor:
    """Differentiable flash attention in the head layout: q [B,Hq,Lq,D],
    k/v [B,Hkv,Lk,D] with Hq % Hkv == 0. Returns [B,Hq,Lq,D] in q's dtype.
    Lengths need not be multiples of a tile: the kernels mask the ragged
    edge themselves, and ``kv_len`` masks a padded tail of k/v."""
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    window = int(window)
    _check(q, k, v, window, kv_len)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return FlashAttnFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                             bool(causal), window, scale, kv_len)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: [B, Hkv, G, Lq, D]; k/v: [B, Hkv, Lk, D] (the model's layout).
    Returns [B, Hkv, G, Lq, D]."""
    if q.dim() != 5:
        raise ValueError(f"q must be [B,Hkv,G,L,D], got {tuple(q.shape)}")
    B, Hkv, G, Lq, D = q.shape
    out = flash_attention_bhld(q.reshape(B, Hkv * G, Lq, D), k, v,
                               causal=causal, window=window, scale=scale)
    return out.reshape(B, Hkv, G, Lq, D)
