"""The port's measurement tools, on the CPU.

``tools/torch_step_profile.py`` books every kernel of a ``torch.profiler``
trace to a group by a mark in its name, first match first. The kernels of
one CUDA source share an anonymous namespace, which nvcc names after the
source and its first entry point (``wkv6_cu_wkv6_fwd`` for ``wkv6.cu``), so
every WKV6 kernel's mangled name holds ``wkv6_fwd``: each must still land in
its own group, in the mangled form that nvcc's ``-Xptxas -v`` log prints
and in the demangled form that a trace shows.
"""
import importlib.util
from pathlib import Path

import pytest

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def load_tool(name: str):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


WKV_NS = "_ZN39_GLOBAL__N__f32662c3_7_wkv6_cu_wkv6_fwd"
ATT_NS = "_ZN46_GLOBAL__N__e2cf8434_13_flash_attn_cu_cd4330bb"
TC_NS = "_ZN49_GLOBAL__N__b3b75d5a_16_flash_attn_tc_cu_fed10b6a"
# kernel names as nvcc 12.8 gave them for sm_90a, and as c++filt prints them
NAMES = [
    (WKV_NS + "15wkv6_fwd_kernelILi64EEEvPKfS2_S2_S2_S2_S2_PfS3_iii", "wkv6_fwd"),
    (WKV_NS + "18wkv6_bwd_dv_kernelILi64EEEvPKfS2_S2_S2_S2_S2_Pfiii", "wkv6_bwd_dv"),
    (WKV_NS + "18wkv6_bwd_dr_kernelILi64EEEvPKfS2_S2_S2_S2_S2_S2_S2_PfS3_S3_iii",
     "wkv6_bwd_dr"),
    (WKV_NS + "18wkv6_bwd_dk_kernelILi64EEEvPKfS2_S2_S2_S2_S2_S2_S2_S2_PfS3_S3_S3_iii",
     "wkv6_bwd_dk"),
    (ATT_NS + "10fwd_kernelIfLi64EEEvPKT_S3_S3_PS1_Pfiiiiiiifi", "flash_attn_fwd"),
    # flash_attn.cu's kernels since they take fp32 only (no type parameter)
    (ATT_NS + "10fwd_kernelILi64EEEvPKfS2_S2_PfS3_iiiiiiifi", "flash_attn_fwd"),
    (ATT_NS + "13bwd_dq_kernelILi64EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiiiiifi",
     "flash_attn_bwd_dq"),
    ("void (anonymous namespace)::wkv6_fwd_kernel<64>(float const*, float const*, "
     "float const*, float const*, float const*, float const*, float*, float*, "
     "int, int, int)", "wkv6_fwd"),
    ("void (anonymous namespace)::wkv6_bwd_dv_kernel<64>(float const*, float const*, "
     "float const*, float const*, float const*, float const*, float*, int, int, "
     "int)", "wkv6_bwd_dv"),
    ("void (anonymous namespace)::fwd_kernel<float, 64>(float const*, float const*, "
     "float const*, float*, float*, int, int, int, int, int, int, int, float, int)",
     "flash_attn_fwd"),
    ("void (anonymous namespace)::fwd_kernel<64>(float const*, float const*, "
     "float const*, float*, float*, int, int, int, int, int, int, int, float, int)",
     "flash_attn_fwd"),
    # flash_attn_tc.cu's, for sm_90a
    (TC_NS + "13fwd_tc_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiiiiif",
     "flash_attn_fwd_tc"),
    (TC_NS + "18bwd_dkdv_tc_kernelILi128EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_"
     "PS1_S6_iiiiiiif", "flash_attn_bwd_dkdv_tc"),
    (TC_NS + "16bwd_dq_tc_kernelILi128EEEvPK13__nv_bfloat16S3_S3_S3_S3_PKfPS1_"
     "Pfiiiiiiif", "flash_attn_bwd_dq_tc"),
    ("void (anonymous namespace)::bwd_dq_tc_kernel<96>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, float const*, __nv_bfloat16*, float*, int, int, "
     "int, int, int, int, int, float)", "flash_attn_bwd_dq_tc"),
    ("void (anonymous namespace)::fwd_tc_kernel<128>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, float*, int, "
     "int, int, int, int, int, int, float)", "flash_attn_fwd_tc"),
    ("void (anonymous namespace)::bwd_dkdv_tc_kernel<96>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "float const*, float const*, __nv_bfloat16*, __nv_bfloat16*, int, int, "
     "int, int, int, int, int, float)", "flash_attn_bwd_dkdv_tc"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x256_8x4_nt_align1>("
     "cutlass_80_simt_sgemm_128x256_8x4_nt_align1::Params)", "matmul"),
]


@pytest.mark.parametrize("name,group", NAMES, ids=[
    f"{g}-{'mangled' if n.startswith('_Z') else 'demangled'}" for n, g in NAMES])
def test_step_profile_books_each_kernel_to_its_group(name, group):
    assert load_tool("torch_step_profile").group_of(name) == group


def test_serve_probe_held_gap_stops_at_each_rows_first_flag():
    """``held_gap``: the largest gap over the positions before each row's
    first flagged token, and their share of all positions."""
    torch = pytest.importorskip("torch")
    probe = load_tool("torch_serve_probe")
    gaps = torch.tensor([[1., 2., 9., 3.], [4., 5., 6., 7.]])
    flagged = torch.tensor([[False, False, True, False], [False] * 4])
    assert probe.held_gap(torch, gaps, flagged) == (7.0, 6 / 8)
    gap, share = probe.held_gap(torch, gaps, torch.ones((2, 4), dtype=bool))
    assert gap != gap and share == 0.0          # nothing held: nan


def test_serve_probe_fp32_control_casts_and_rescales_in_place():
    """``fp32_control`` on jamba SMOKE in bf16: the control's config is
    fp32 with capacity_factor E / K; each leaf is the bf16 value in fp32,
    a stacked layer matrix rescaled to 1/sqrt(d_in); the caller's tree
    becomes the control's."""
    torch = pytest.importorskip("torch")
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    probe = load_tool("torch_serve_probe")
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", smoke=True),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    before = {k: t.clone() for k, t in tree_leaves(params)}
    ctl, ps = probe.fp32_control(cfg, params)
    assert (ctl.param_dtype, ctl.compute_dtype) == ("float32", "float32")
    assert ctl.moe.capacity_factor == cfg.moe.n_experts / cfg.moe.top_k
    assert ps is params
    got = dict(tree_leaves(ps))
    assert got.keys() == before.keys()
    for k, t in before.items():
        assert got[k].dtype == torch.float32
        scale = (t.shape[0] / t.shape[-2]) ** 0.5 \
            if k.startswith("layers/") and t.dim() >= 3 else 1.0
        torch.testing.assert_close(got[k], t.float() * scale, rtol=0,
                                   atol=0, msg=k)


def test_serve_probe_reads_moe_routing_per_moe_layer():
    """``moe_decode_gaps`` on jamba SMOKE at 4 layers (2 MoE) in fp32 at
    capacity_factor E / K: the teacher-forced pass and the decode route
    alike and drop nothing, every position is held, and the gap is fp32
    rounding."""
    torch = pytest.importorskip("torch")
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    probe = load_tool("torch_serve_probe")
    cfg = get_config("jamba-v0.1-52b", smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=4, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 10),
                           generator=torch.Generator().manual_seed(1))
    r = probe.moe_decode_gaps(torch, cfg, params, tokens, 4)
    assert r["token_layers"] == 2 * 10 * 2          # B x T x MoE layers
    assert r["claims"] == r["token_layers"] * cfg.moe.top_k
    assert r["dropped_claims"] == r["decode_dropped_claims"] == 0
    assert r["tokens_routed_otherwise"] == 0 and r["held_share"] == 1.0
    assert r["held"] == r["teacher_forcing"] < 1e-4
