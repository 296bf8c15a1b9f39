"""The trace reader on a synthetic trace of two devices with copies."""
import pytest

from edlbench import trace


def ev(cat, name, ts, dur, device=None, **kw):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X", **kw}
    if device is not None:
        e["args"] = {"device": device}
    return e


EVENTS = [
    ev("user_annotation", trace.WINDOW, 1000, 1000),
    ev("user_annotation", "edlbench.step", 1000, 1000),
    ev("cpu_op", "aten::item", 1600, 300),
    # device 0: a GEMM, a flash kernel, a memset; one event before the window
    ev("kernel", "sm90_xmma_gemm_bf16", 900, 200, device=0),
    ev("kernel", "void fwd_tc_kernel<96>", 1150, 100, device=0),
    ev("gpu_memset", "Memset (Device)", 1250, 50, device=0),
    ev("kernel", "elementwise_kernel", 1800, 300, device=0),
    # device 1: a peer copy that a kernel overlaps
    ev("gpu_memcpy", "Memcpy PtoP (Device -> Device)", 1000, 400, device=1),
    ev("kernel", "void wkv6_fwd_kernel<64>", 1300, 200, device=1),
]


def test_busy_is_per_device_and_copies_count():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(1e-3)
    # device 0: [1000, 1100] + [1150, 1300] + [1800, 2000] (clipped)
    assert s["busy_s"][0] == pytest.approx(450e-6)
    # device 1: the union of [1000, 1400] and [1300, 1500]
    assert s["busy_s"][1] == pytest.approx(500e-6)
    assert s["copy_s"] == pytest.approx(450e-6)
    assert s["launches"] == 4
    assert s["group_s"]["matmul"] == pytest.approx(100e-6)
    assert s["group_s"]["flash_attn_fwd_tc"] == pytest.approx(100e-6)
    assert s["group_s"]["wkv6_fwd"] == pytest.approx(200e-6)
    assert s["group_s"]["other"] == pytest.approx(200e-6)


def test_idle_gaps_are_named_by_the_host_op():
    gaps = dict(trace.summarize(EVENTS)["idle_gaps"])
    # device 0 is idle over [1100, 1150] and [1300, 1800], whose middles
    # fall in the step span alone; device 1 over [1500, 2000], whose
    # middle falls in aten::item, the innermost op there
    assert gaps["edlbench.step"] == pytest.approx(550e-6)
    assert gaps["aten::item"] == pytest.approx(500e-6)


def test_no_window_is_refused():
    with pytest.raises(ValueError):
        trace.summarize(EVENTS[1:])
