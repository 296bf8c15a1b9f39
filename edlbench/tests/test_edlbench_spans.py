"""The attribution of device time to the program's spans (``trace.py``)
and the readers of the span metrics (``metrics/``, ``readers.py``) on a
synthetic trace of one step: a forward, a backward whose recompute and
kernels run on autograd's thread, an update with a copy, a host sync, and
device work under no span."""
import pytest

from edlbench import readers, run, trace


def host(name, ts, dur, tid=1):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "ph": "X", "tid": tid}


def launch(corr, ts, tid=1):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 2, "ph": "X", "tid": tid, "args": {"correlation": corr}}


def dev(corr, ts, dur, cat="kernel", name="k"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X",
            "pid": 0, "tid": 7, "args": {"device": 0, "correlation": corr}}


EVENTS = [
    host(trace.WINDOW, 900, 1200),
    host("edl.step", 1000, 1000),
    host("edl.data", 1005, 40),
    host("edl.forward", 1050, 250),
    host("edl.backward", 1300, 400),
    host("edl.update", 1700, 100),
    host("edl.sync", 1800, 190),
    # autograd's thread: remat's recompute inside the backward
    host("edl.recompute", 1350, 170, tid=2),
    # the same range on the device's timeline is not a host span
    {"cat": "gpu_user_annotation", "name": "edl.sync", "ts": 900,
     "dur": 1200, "ph": "X", "pid": 0, "tid": 7},
    # launched before the step: under no span
    launch(5, 950), dev(5, 960, 40),
    # the forward's kernels, a gap of 3 us between them
    launch(1, 1100), dev(1, 1110, 90, name="sm90_xmma_gemm_bf16"),
    launch(7, 1105), dev(7, 1203, 7),
    # on autograd's thread inside its recompute
    launch(2, 1370, tid=2), dev(2, 1380, 120),
    # on autograd's thread with no span of its own open: the main
    # thread's backward
    launch(3, 1590, tid=2), dev(3, 1600, 90),
    # the update's copy
    launch(4, 1745), dev(4, 1750, 40, cat="gpu_memcpy", name="Memcpy DtoD"),
    # no launch in the trace
    dev(99, 2000, 50),
]


def test_device_time_goes_to_the_innermost_span_at_launch():
    s = trace.summarize(EVENTS)["span_device_s"]
    assert s == pytest.approx({"edl.forward": 97e-6, "edl.recompute": 120e-6,
                               "edl.backward": 90e-6, "edl.update": 40e-6,
                               "unattributed": 90e-6})


def test_device_time_by_kernel_group_and_kernel_count():
    s = trace.summarize(EVENTS)
    assert s["span_group_s"] == {
        "edl.forward": {"matmul": pytest.approx(90e-6),
                        "other": pytest.approx(7e-6)},
        "edl.recompute": {"other": pytest.approx(120e-6)},
        "edl.backward": {"other": pytest.approx(90e-6)},
        "edl.update": {"copy": pytest.approx(40e-6)},
        "unattributed": {"other": pytest.approx(90e-6)}}
    assert s["span_kernels"] == {"edl.forward": 2, "edl.recompute": 1,
                                 "edl.backward": 1, "edl.update": 0,
                                 "unattributed": 2}


def test_host_time_by_span_name():
    s = trace.summarize(EVENTS)["span_host_s"]
    assert s == pytest.approx({"edl.step": 1000e-6, "edl.data": 40e-6,
                               "edl.forward": 250e-6, "edl.backward": 400e-6,
                               "edl.update": 100e-6, "edl.sync": 190e-6,
                               "edl.recompute": 170e-6})


def test_launch_calls_host_time():
    """Six launches of 2 us each inside the window."""
    assert trace.summarize(EVENTS)["launch_host_s"] == pytest.approx(12e-6)


def test_host_own_time_leaves_out_the_sync_and_every_cuda_call():
    """The step's 1,000 us less its sync [1800, 1990] and the CUDA calls
    inside it on either thread: five launches of 2 us (the one at 950 is
    before the step) and a stream sync [1790, 1995] that overlaps the
    sync span, counted once: 1000 - 10 - 205 = 785 us."""
    wait = {"cat": "cuda_runtime", "name": "cudaStreamSynchronize",
            "ts": 1790, "dur": 205, "ph": "X", "tid": 1, "args": {}}
    assert trace.summarize(EVENTS)["host_own_s"] == pytest.approx(800e-6)
    assert trace.summarize(EVENTS + [wait])["host_own_s"] == \
        pytest.approx(785e-6)


def test_idle_gaps_are_named_by_the_open_span():
    """Device 0's gaps: [900, 960] outside; [1000, 1110] in the forward
    (the data span ended at 1045); [1200, 1203] is under 10 us; [1210,
    1380] in the forward (middle 1295); [1500, 1600] in the backward;
    [1690, 1750] in the update; [1790, 2000] in the sync; [2050, 2100]
    outside."""
    s = trace.summarize(EVENTS)["idle_by_span"]
    assert s == pytest.approx({"outside": 110e-6, "edl.forward": 280e-6,
                               "edl.backward": 100e-6, "edl.update": 60e-6,
                               "edl.sync": 210e-6})


def test_a_trace_without_spans_reads_nothing():
    """The parent's program opens no ``edl.*`` span: every device second
    is unattributed and no reader gives a value."""
    plain = [e for e in EVENTS if not e["name"].startswith("edl.")]
    s = trace.summarize(plain)
    assert set(s["span_device_s"]) == {"unattributed"}
    assert s["span_host_s"] == {} and s["span_within_s"] == {}
    rec = {"trace": s, "trace_steps": [{"p": 1}]}
    assert all(run.reader(n).read(rec) is None for n in SPAN_METRICS)


def test_a_span_nested_in_a_phase_leaves_the_phases_as_they_are():
    """The program opens ``edl.moe`` inside the forward around its second
    kernel: the phases' device time is as it was, and the nested span's
    is readable through ``span_within_s``, where the forward holds it
    too."""
    nested = EVENTS + [host("edl.moe", 1102, 10)]
    before, after = trace.summarize(EVENTS), trace.summarize(nested)
    for k in ("span_device_s", "span_group_s", "span_kernels"):
        assert after[k] == before[k]
    assert after["span_within_s"] == pytest.approx(
        {**before["span_within_s"], "edl.moe": 7e-6})
    assert after["span_within_s"]["edl.forward"] == pytest.approx(97e-6)
    rec = {"trace": after, "trace_steps": [{"p": 1}]}
    assert readers.span_ms(rec, "edl.moe", within=True) == \
        pytest.approx(7e-3)
    assert readers.span_ms(rec, "edl.moe") is None
    assert run.reader("forward_ms").read(rec) == pytest.approx(97e-3)


def test_device_time_within_every_open_span():
    """Each kernel counts under every span open at its launch: autograd's
    thread's recompute alone where that thread has one open, else the main
    thread's step and backward."""
    s = trace.summarize(EVENTS)["span_within_s"]
    assert s == pytest.approx({"edl.step": 227e-6, "edl.forward": 97e-6,
                               "edl.recompute": 120e-6,
                               "edl.backward": 90e-6, "edl.update": 40e-6})


SPAN_METRICS = ("forward_ms", "backward_ms", "recompute_ms", "update_ms",
                "data_wait_ms", "host_ms")

# a run record of two traced steps, made by hand
RUN = {"trace": {"busy_s": {0: 2.0}, "window_s": 2.1,
                 "span_device_s": {"edl.forward": 0.5, "edl.backward": 0.9,
                                   "edl.recompute": 0.4, "edl.update": 0.2,
                                   "unattributed": 0.02},
                 "span_host_s": {"edl.step": 2.08, "edl.sync": 1.6,
                                 "edl.data": 0.004},
                 "host_own_s": 0.48,
                 "idle_by_span": {"edl.sync": 0.06, "outside": 0.02}},
       "trace_steps": [{"p": 1}, {"p": 1}]}


@pytest.mark.parametrize("name,value", [
    ("forward_ms", 250.0), ("backward_ms", 450.0), ("recompute_ms", 200.0),
    ("update_ms", 100.0), ("data_wait_ms", 2.0), ("host_ms", 240.0)])
def test_reader(name, value):
    assert run.reader(name).read(RUN) == pytest.approx(value)


def test_reader_without_a_trace_reads_nothing():
    assert all(run.reader(n).read({"trace": None, "trace_steps": None})
               is None for n in SPAN_METRICS)


def test_step_values_read_what_the_step_returned():
    """A counter the program's ``step()`` returns reaches the readers, over
    the traced and the untraced steps in order."""
    steps = [{"values": {"loss": 5.0, "dropped": 3.0}},
             {"values": {"loss": 4.0}},
             {"values": {"loss": 3.5, "dropped": 1.0}}]
    rec = {"window": {"steps": steps}, "trace_steps": steps[1:2],
           "untraced_steps": steps[:1] + steps[2:]}
    assert readers.step_values(rec, "dropped") == [3.0, 1.0]
    assert readers.step_values(rec, "loss") == [5.0, 4.0, 3.5]
    assert readers.step_values(rec, "absent") is None
    assert readers.step_values({"window": None}, "loss") is None


def test_a_traced_cpu_run_holds_the_step_spans_and_values():
    """The tiny phi3 cell traced on the CPU: the host times name each of
    the step's seven spans; the CPU trace has no device work to
    attribute; every window step keeps what ``step()`` returned."""
    import time
    import torch
    from helpers import tiny_files
    out = run.run_cell(tiny_files("phi3.b2x8k"), 2**31 + 5, 0.5, True,
                       [torch.device("cpu")],
                       trainer_kw={"time_allowance_s": 0},
                       t_start=time.monotonic())
    rec = out["run"]
    tr = rec["trace"]
    assert set(tr["span_host_s"]) == set(trace.PHASES)
    assert tr["span_device_s"] == {} and tr["idle_by_span"] == {}
    assert out["result"]["correct"], out["result"]["compared"]
    losses = readers.step_values(rec, "loss")
    assert len(losses) == len(rec["window"]["steps"]) >= 1
    assert readers.step_values(rec, "grad_norm")[0] > 0
    assert set(readers.step_values(rec, "p")) == {1}
