"""The tensor-core flash-attention kernels' source, run on the CPU.

``flash_attn_fwd_tc``, ``flash_attn_bwd_dq_tc`` and
``flash_attn_bwd_dkdv_tc`` of
``src/repro_torch/kernels/csrc/flash_attn_tc.cu`` go through the translator
of ``test_torch_cuda_emulate.py`` (each CUDA thread a ``std::thread``;
``wgmma`` by its stand-ins there: the shared-memory descriptors decoded
with the 128-byte swizzle, the A fragments read from the other lanes'
registers, each thread's accumulator elements in the PTX ISA's layout),
with the products formed at the wait or at the issue, and are held against
the plain PyTorch versions at small shapes: head dims 16 to 128, GQA at G
1, 4, 5 and 12, a window that ends inside a tile, ``kv_len`` with Lq != Lk,
non-causal, lengths at the tiles' edges, rows that do not start on a
16-byte boundary (copied by the wrapper's ``aligned16``), and two runs that
must give the same bits. dK/dV runs after ``flash_attn_bwd_dq_tc``, which
writes its delta, as on the card. Run from the repo root:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_emulate_tc.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import ops
from test_torch_cuda_emulate import AttentionLibs, randn, run, run_fwd

BF16 = torch.bfloat16
TOL = 2e-2   # chip_smoke.py's bf16 tolerance, |a - b| <= tol (1 + |b|)
CASES = [  # B, Hq, Hkv, Lq, Lk, D, causal, window, kv_len
    # every head dim the CUDA path takes: one panel, part of one, a panel
    # and a half, two panels
    *[(1, 2, 2, 130, 130, d, True, 0, None) for d in ops.CUDA_HEAD_DIMS],
    # GQA: G = 4, 5 (qwen SMOKE's 5 q heads on 1) and 12 (starcoder2)
    (1, 8, 2, 100, 100, 64, True, 0, None),
    (1, 5, 1, 100, 100, 96, True, 0, None),
    (1, 12, 1, 80, 80, 128, True, 0, None),
    # a window that ends inside a tile, at two head dims
    (1, 2, 2, 300, 300, 64, True, 100, None),
    (1, 8, 2, 200, 200, 128, True, 40, None),
    # kv_len below Lk with Lq != Lk, non-causal and causal
    (1, 4, 2, 150, 192, 32, False, 0, 166),
    (1, 2, 2, 100, 160, 64, True, 0, 120),
    (1, 2, 2, 64, 129, 64, False, 0, None),
    (1, 2, 2, 129, 64, 96, False, 0, None),
    # at the 64-row tiles' and the 128-row forward blocks' edges
    *[(1, 2, 2, n, n, 64, True, 0, None) for n in (63, 64, 65, 127, 128, 129)],
    # two batch rows
    (2, 4, 2, 96, 96, 128, True, 0, None),
]


def case_id(c):
    return "-".join(str(x) for x in c)


@pytest.fixture(scope="module", params=["copy_at_wait", "copy_at_issue"])
def libs(request, tmp_path_factory):
    return AttentionLibs(request, tmp_path_factory)


def test_bf16_goes_to_the_tensor_core_kernels():
    assert ops.kernel_names(BF16) == ("flash_attn_fwd_tc",
                                      "flash_attn_bwd_dq_tc",
                                      "flash_attn_bwd_dkdv_tc")
    assert ops.kernel_names(torch.float32) == (
        "flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkdv")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_forward_tc_matches_plain(libs, case):
    worst, ok, _ = run_fwd(libs, *case, BF16)
    assert ok, f"max_abs_err {worst:.2e} over tolerance {TOL}"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_dkdv_tc_matches_plain(libs, case):
    """``flash_attn_bwd_dq_tc`` (dq, and the delta it writes), then
    ``flash_attn_bwd_dkdv_tc``; each against its plain version on the same
    inputs."""
    worst, ok, _ = run(libs, *case, BF16, TOL)
    assert ok, f"max_abs_err {worst:.2e} over tolerance {TOL}"


@pytest.mark.parametrize("kernel", ["forward", "backward"])
def test_tc_kernels_on_unaligned_rows(libs, kernel):
    """Inputs one element into their storage: the wrapper's ``aligned16``
    copies them, as ``ops`` does before a launch."""
    case = (1, 4, 2, 130, 130, 96, True, 0, None, BF16)
    if kernel == "forward":
        worst, ok, _ = run_fwd(libs, *case, offset=True)
    else:
        worst, ok, _ = run(libs, *case, TOL, offset=True)
    assert ok, f"max_abs_err {worst:.2e} over tolerance {TOL}"


@pytest.mark.parametrize("kernel", ["forward", "backward"])
def test_tc_kernels_give_the_same_bits_twice(libs, kernel):
    case = (1, 8, 2, 192, 192, 128, True, 0, None, BF16)
    if kernel == "forward":
        runs = [run_fwd(libs, *case, seed=3)[2] for _ in range(2)]
    else:
        runs = [run(libs, *case, TOL, seed=3)[2] for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_tc_entry_points_refuse_fp32_and_unaligned_rows(libs):
    """dtype 0 is flash_attn.cu's; a bf16 tensor off a 16-byte boundary is
    refused (cudaErrorMisalignedAddress), not read by cp.async or as bf16
    pairs (dQ's o)."""
    gen = torch.Generator().manual_seed(0)
    B, H, L, D = 1, 2, 64, 64
    q, k, v = (randn(gen, (B, H, L, D), BF16) for _ in range(3))
    o, lse = torch.empty_like(q), torch.empty(B, H, L)
    dims = [B, H, H, L, L, D, L, 1, 0]
    ptrs = [t.data_ptr() for t in (q, k, v, o, lse)]
    assert libs.flash_attn_fwd_tc(*ptrs, *dims, D ** -0.5, 0, None) == 1
    qu = randn(gen, (B, H, L, D), BF16, offset=True)
    assert qu.data_ptr() % 16 != 0
    ptrs[0] = qu.data_ptr()
    assert libs.flash_attn_fwd_tc(*ptrs, *dims, D ** -0.5, 1, None) == 716
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    bwd = [t.data_ptr() for t in (qu, k, v, q, lse, lse, dk, dv)]
    assert libs.flash_attn_bwd_dkdv_tc(*bwd, *dims, D ** -0.5, 1, None) == 716
    dq, delta = torch.empty_like(q), torch.empty(B, H, L)
    dq_args = [q, k, v, o, q, lse, dq, delta]
    assert libs.flash_attn_bwd_dq_tc(*[t.data_ptr() for t in dq_args], *dims,
                                     D ** -0.5, 0, None) == 1
    dq_args[3] = qu   # o
    assert libs.flash_attn_bwd_dq_tc(*[t.data_ptr() for t in dq_args], *dims,
                                     D ** -0.5, 1, None) == 716


def test_cuda_core_dq_refuses_bf16(libs):
    """Every bf16 dQ is ``flash_attn_bwd_dq_tc``'s: ``flash_attn.cu``'s
    ``flash_attn_bwd_dq`` refuses dtype 1 (cudaErrorInvalidValue), as its
    forward and dK/dV do."""
    gen = torch.Generator().manual_seed(0)
    B, H, L, D = 1, 2, 64, 64
    q, k, v, o, do = (randn(gen, (B, H, L, D), BF16) for _ in range(5))
    lse, delta, dq = torch.zeros(B, H, L), torch.empty(B, H, L), torch.empty_like(q)
    dims = [B, H, H, L, L, D, L, 1, 0]
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, lse, dq, delta)]
    assert libs.flash_attn_bwd_dq(*ptrs, *dims, D ** -0.5, 1, None) == 1
