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
# kernel names as nvcc 12.8 gave them for sm_90a, and as c++filt prints them
NAMES = [
    (WKV_NS + "15wkv6_fwd_kernelILi64EEEvPKfS2_S2_S2_S2_S2_PfS3_iii", "wkv6_fwd"),
    (WKV_NS + "18wkv6_bwd_dv_kernelILi64EEEvPKfS2_S2_S2_S2_S2_Pfiii", "wkv6_bwd_dv"),
    (WKV_NS + "18wkv6_bwd_dr_kernelILi64EEEvPKfS2_S2_S2_S2_S2_S2_S2_PfS3_S3_iii",
     "wkv6_bwd_dr"),
    (WKV_NS + "18wkv6_bwd_dk_kernelILi64EEEvPKfS2_S2_S2_S2_S2_S2_S2_S2_PfS3_S3_S3_iii",
     "wkv6_bwd_dk"),
    (ATT_NS + "10fwd_kernelIfLi64EEEvPKT_S3_S3_PS1_Pfiiiiiiifi", "flash_attn_fwd"),
    ("void (anonymous namespace)::wkv6_fwd_kernel<64>(float const*, float const*, "
     "float const*, float const*, float const*, float const*, float*, float*, "
     "int, int, int)", "wkv6_fwd"),
    ("void (anonymous namespace)::wkv6_bwd_dv_kernel<64>(float const*, float const*, "
     "float const*, float const*, float const*, float const*, float*, int, int, "
     "int)", "wkv6_bwd_dv"),
    ("void (anonymous namespace)::fwd_kernel<float, 64>(float const*, float const*, "
     "float const*, float*, float*, int, int, int, int, int, int, int, float, int)",
     "flash_attn_fwd"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x256_8x4_nt_align1>("
     "cutlass_80_simt_sgemm_128x256_8x4_nt_align1::Params)", "matmul"),
]


@pytest.mark.parametrize("name,group", NAMES, ids=[
    f"{g}-{'mangled' if n.startswith('_Z') else 'demangled'}" for n, g in NAMES])
def test_step_profile_books_each_kernel_to_its_group(name, group):
    assert load_tool("torch_step_profile").group_of(name) == group
