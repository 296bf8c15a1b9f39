"""The yardstick's arithmetic against the bounds PERF.md reports."""
import math

import pytest

from edlbench import counts, run
from edlbench.reference import kind
from edlbench.reference import model as ref

from helpers import configs, kinds, small


def test_flash_attn_fwd_bound_is_perf_md_s():
    # B 8, H 12, L 1024, D 64, fp32, causal: 0.192 ms, bound by operations
    B, H, L, D = 8, 12, 1024, 64
    work = counts.attention_work(("f", "q", "kv"), B, H, H, L, L, D, 4,
                                 B * H * counts.causal_pairs(L))
    nbytes, flops = work["f"]
    assert flops / counts.PEAK_FP32_FLOPS > nbytes / counts.PEAK_HBM_BYTES
    assert counts.bound_s(nbytes, flops, counts.PEAK_FP32_FLOPS) * 1e3 \
        == pytest.approx(0.192, abs=5e-4)


def test_wkv6_fwd_bound_is_perf_md_s():
    # B 8, H 32, L 1024, hd 64: 0.103 ms, bound by bytes
    nbytes, flops = counts.wkv_work(8, 1024, 32, 64)["wkv6_fwd"]
    assert nbytes / counts.PEAK_HBM_BYTES > flops / counts.PEAK_FP32_FLOPS
    assert counts.bound_s(nbytes, flops, counts.PEAK_FP32_FLOPS) * 1e3 \
        == pytest.approx(0.103, abs=5e-4)


@pytest.mark.parametrize("config,matmul,step_tflop", [
    ("rwkv6-1.6b", 1.449e9, 71.6), ("phi3-mini-16l", 1.910e9, 227.4)])
def test_model_flops(config, matmul, step_tflop):
    m = run.load_json(run.HERE / "configs" / f"{config}.json")
    t = run.load_json(run.HERE / "traffic" / (
        "b2x8k.json" if config.startswith("phi3") else "b8x1k.json"))
    assert counts.matmul_params(m) == pytest.approx(matmul, rel=1e-3)
    flops = counts.step_model_flops(m, t["global_batch"], t["seq_len"])
    assert flops / 1e12 == pytest.approx(step_tflop, rel=2e-3)


def test_phi3_counts_are_pinned():
    """``phi3.b2x8k``'s counts, which ``step_mfu.steady`` divides by, to
    the integer."""
    m = run.load_json(run.HERE / "configs" / "phi3-mini-16l.json")
    assert counts.matmul_params(m) == 1_910_439_936
    assert counts.mixer_forward_flops(m, 2, 8192) == 13_195_750_146_048
    assert counts.step_model_flops(m, 2, 8192) == 227_391_137_906_688


@pytest.mark.parametrize("model", kinds())
def test_counts_go_through_the_kind(model):
    """At the kind's ``TINY`` sizes: the counts are its module's, no more
    matrix parameters than its tree holds, the mixer's flops linear in the
    rows."""
    m = small(configs(model)[0])
    k = kind(m)
    n_params = sum(math.prod(s) for _, s, _, _ in ref.param_specs(m))
    assert 0 < counts.matmul_params(m) == k.matmul_params(m) <= n_params
    B, L = 3, 16
    mixer = counts.mixer_forward_flops(m, B, L)
    assert mixer == k.mixer_forward_flops(m, B, L) > 0
    assert counts.mixer_forward_flops(m, 2 * B, L) == 2 * mixer
    assert counts.step_model_flops(m, B, L) == \
        6 * counts.matmul_params(m) * B * L + 3 * mixer


def test_per_step_bounds():
    m = run.load_json(run.HERE / "configs" / "phi3-mini-16l.json")
    t = run.load_json(run.HERE / "traffic" / "b2x8k.json")
    # 2 x 0.833 (forward and its recomputation) + 1.25 + 1.67 ms a layer
    assert counts.attention_bound_s(m, t, 1) * 1e3 / 16 == pytest.approx(
        4.58, abs=0.01)
    # four groups of two rows do the work of one such step each
    wide = dict(t, global_batch=8)
    assert counts.attention_bound_s(m, wide, 4) == pytest.approx(
        4 * counts.attention_bound_s(m, t, 1))
    r = run.load_json(run.HERE / "configs" / "rwkv6-1.6b.json")
    rt = run.load_json(run.HERE / "traffic" / "b8x1k.json")
    # bounds 2 x 0.103 + 0.143 + 0.163 + 0.101 ms a layer
    assert counts.wkv_bound_s(r, rt, 1) * 1e3 / 24 == pytest.approx(
        0.613, abs=0.003)
