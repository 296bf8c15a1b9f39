"""Which kernels the attention wrapper dispatches to, by dtype, as the
dry-run sees it on ``meta`` (no card): bf16's forward, dQ and dK/dV are
the tensor-core kernels of ``flash_attn_tc.cu`` (``flash_attn_fwd_tc``,
``flash_attn_bwd_dq_tc``, ``flash_attn_bwd_dkdv_tc``); fp32 keeps
``flash_attn_fwd``, ``flash_attn_bwd_dq`` and ``flash_attn_bwd_dkdv``. ``COSTS`` books each call's work under the
kernels that would run, at ``flash_work``'s flops and bytes."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import InputShape, get_config
from repro_torch.kernels.attention import ops
from repro_torch.kernels.launches import COSTS
from repro_torch.launch import dryrun as D

BF16, F32 = torch.bfloat16, torch.float32
TRAIN = InputShape("train_small", 64, 4, "train")


def _meta(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _booked(snap) -> dict:
    """{kernel: (flops, bytes)} of the attention kernels that were booked."""
    return {n: (snap["flops"][n], snap["bytes"][n]) for n in ops.KERNELS
            if snap["flops"][n] or snap["bytes"][n]}


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_a_meta_call_books_flash_work_under_its_dtypes_kernels(dtype,
                                                               window):
    COSTS.reset()
    q = _meta(2, 8, 96, 128, dtype=dtype).requires_grad_()
    k = _meta(2, 2, 96, 128, dtype=dtype).requires_grad_()
    v = _meta(2, 2, 96, 128, dtype=dtype).requires_grad_()
    o = ops.flash_attention_bhld(q, k, v, window=window)
    o.sum().backward()
    work = ops.flash_work(q, k, True, window, 96)
    assert _booked(COSTS.snapshot()) == {n: work[n]
                                         for n in ops.kernel_names(dtype)}


def test_a_tensor_core_kernel_does_the_work_of_the_one_it_stands_in_for():
    q, k = _meta(1, 4, 200, 96, dtype=BF16), _meta(1, 2, 200, 96, dtype=BF16)
    work = ops.flash_work(q, k, True, 0, 200)
    assert work["flash_attn_fwd_tc"] == work["flash_attn_fwd"]
    assert work["flash_attn_bwd_dq_tc"] == work["flash_attn_bwd_dq"]
    assert work["flash_attn_bwd_dkdv_tc"] == work["flash_attn_bwd_dkdv"]
    pairs = 4 * ops.visible_pairs(200, 200, True, 0, 200)
    assert work["flash_attn_fwd_tc"][0] == 4 * 96 * pairs
    assert work["flash_attn_bwd_dq_tc"][0] == 6 * 96 * pairs
    assert work["flash_attn_bwd_dkdv_tc"][0] == 8 * 96 * pairs


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_meta_train_step_books_attention_under_its_dtypes_kernels(dtype):
    """mistral-nemo SMOKE's training step in the dry-run: each of its GQA
    layers books one forward and one of each backward kernel, of its
    dtype's kernels and no other, at ``flash_work`` of the layer's q and
    k."""
    cfg = dataclasses.replace(get_config("mistral-nemo-12b", smoke=True),
                              param_dtype=dtype, compute_dtype=dtype)
    assert cfg.attn_kind == "gqa" and not cfg.remat
    r = D.dryrun(cfg, TRAIN, (1, 1))
    assert r["status"] == "OK"
    tdtype = getattr(torch, dtype)
    hd = cfg.resolved_head_dim
    q = _meta(TRAIN.global_batch, cfg.n_heads, TRAIN.seq_len, hd, dtype=tdtype)
    k = _meta(TRAIN.global_batch, cfg.n_kv_heads, TRAIN.seq_len, hd,
              dtype=tdtype)
    work = ops.flash_work(q, k, True, cfg.window, TRAIN.seq_len)
    names = ops.kernel_names(tdtype)
    got = {n: (r["kernel_flops"][n], r["kernel_bytes"][n])
           for n in r["kernel_flops"] if n in ops.KERNELS}
    assert got == {n: tuple(cfg.n_layers * x for x in work[n])
                   for n in names}
