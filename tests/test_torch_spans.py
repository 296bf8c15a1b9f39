"""The step path's ``edl.*`` spans (``repro_torch.obs.trace.span``) on the
CPU: under ``torch.profiler`` a default step and a virtual-worker step
each show the span tree the step implies; without a profiler no span
opens a ``record_function``; the profiler changes no bit of the losses or
of the state. Also the port's own records around them: the bytes a switch
moves inside its stop, and the ``Tracer``'s export on the epoch clock
that ``torch.profiler`` writes."""
import dataclasses
import json
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config
from repro_torch.core import ElasticTrainer
from repro_torch.kernels import launches
from repro_torch.models.params import tree_leaves
from repro_torch.obs.trace import Tracer, span

BATCH, SEQ = 4, 32
STEP_SPANS = ("edl.data", "edl.forward", "edl.backward", "edl.update",
              "edl.sync")


def _trainer(*, remat=True, **kw):
    cfg = dataclasses.replace(get_config("edl-paper", smoke=True),
                              remat=remat)
    args = dict(global_batch=BATCH, seq_len=SEQ, init_parallelism=2,
                n_samples=64, d_partitions=8, seed=0,
                devices=["cpu"] * 4, device="cpu", time_allowance_s=0)
    args.update(kw)
    return ElasticTrainer(cfg, **args)


def _profiled(fn, tmp_path):
    """``fn()`` under a CPU ``torch.profiler``; its result and the
    ``edl.*`` spans of the trace as (name, start, end), in µs."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"])
             for e in trace["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith("edl.")]
    return out, spans, trace


def _inside(child, parents) -> bool:
    return any(a <= child[1] and child[2] <= b for _, a, b in parents)


def _count_remat_regions(monkeypatch) -> list:
    """One entry per ``torch.utils.checkpoint`` region that ``remat``
    opens from here on."""
    made = []
    real = launches.recompute_context

    def counting():
        made.append(1)
        return real()
    monkeypatch.setattr(launches, "recompute_context", counting)
    return made


@pytest.mark.parametrize("virtual", [0, 4], ids=["default", "virtual"])
def test_a_profiled_step_shows_the_span_tree(virtual, monkeypatch,
                                             tmp_path):
    """``edl.step`` holds one ``edl.data`` of the batch's assembly and one
    of its copies to the groups, one ``edl.forward`` and one
    ``edl.backward`` per data group (per virtual worker in the virtual
    step), every ``edl.recompute`` inside a backward, one per remat
    region, and one ``edl.update`` and one ``edl.sync``."""
    with _trainer(virtual_workers=virtual) as t:
        t.step()                        # outside the profiler
        regions = _count_remat_regions(monkeypatch)
        out, spans, _ = _profiled(t.step, tmp_path)
    assert out is not None
    by = {n: [s for s in spans if s[0] == n] for n in
          ("edl.step", "edl.recompute") + STEP_SPANS}
    passes = virtual or 2
    assert {n: len(v) for n, v in by.items()} == {
        "edl.step": 1, "edl.data": 2, "edl.forward": passes,
        "edl.backward": passes, "edl.recompute": len(regions),
        "edl.update": 1, "edl.sync": 1}
    # two layers a pass, at least, and no other span name
    assert len(regions) >= 2 * passes
    assert len(spans) == sum(len(v) for v in by.values())
    for name in STEP_SPANS:
        assert all(_inside(s, by["edl.step"]) for s in by[name]), name
    assert all(_inside(s, by["edl.backward"]) for s in by["edl.recompute"])
    # the phases follow one another: forward before its backward, the
    # update after every backward, the sync after the update
    last_bwd = max(b for _, _, b in by["edl.backward"])
    assert by["edl.update"][0][1] >= last_bwd
    assert by["edl.sync"][0][1] >= by["edl.update"][0][2]
    for (_, f0, f1), (_, b0, _) in zip(sorted(by["edl.forward"],
                                              key=lambda s: s[1]),
                                       sorted(by["edl.backward"],
                                              key=lambda s: s[1])):
        assert f1 <= b0


def test_without_a_profiler_no_span_opens_a_record_function(monkeypatch,
                                                             tmp_path):
    """The spans cost a flag check alone: with no profiler recording,
    ``span`` never calls ``record_function``; under one, the same step
    calls it for each of its spans."""
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        if name.startswith("edl."):
            opened.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with _trainer() as t:
        t.step()
        assert opened == []
        with span("edl.step"):
            pass
        assert opened == []
        _, spans, _ = _profiled(t.step, tmp_path)
    assert sorted(opened) == sorted(n for n, _, _ in spans) and opened


def test_the_profiler_changes_no_bit(tmp_path):
    """Three steps with and without the profiler: the same losses and the
    same state, bit for bit."""
    def three_steps(profiled: bool):
        with _trainer() as t:
            if profiled:
                losses, _, _ = _profiled(
                    lambda: [t.step()["loss"] for _ in range(3)], tmp_path)
            else:
                losses = [t.step()["loss"] for _ in range(3)]
            return losses, dict(tree_leaves(t.whole_state()))
    plain_losses, plain = three_steps(False)
    traced_losses, traced = three_steps(True)
    assert traced_losses == plain_losses
    assert plain.keys() == traced.keys()
    for k, v in plain.items():
        assert torch.equal(v, traced[k]), k


@pytest.mark.parametrize("virtual", [0, 4], ids=["default", "virtual"])
def test_a_blocking_switchs_warm_up_opens_no_span(virtual, monkeypatch,
                                                  tmp_path):
    """A blocking scale-out warms its new context on the calling thread,
    through the step's own functions, then steps until it commits. Under
    the profiler only those steps open spans: every other ``edl.*`` span
    lies inside an ``edl.step``, one forward a data group (virtual
    worker) of each step, though the warm-up ran its forward too."""
    warm_ups = []
    real = ElasticTrainer._warm_once

    def counting(self, *a):
        warm_ups.append(1)
        return real(self, *a)
    monkeypatch.setattr(ElasticTrainer, "_warm_once", counting)
    with _trainer(init_parallelism=1, virtual_workers=virtual) as t:
        t.step()
        warm_ups.clear()
        rec, spans, _ = _profiled(lambda: t.scale_out(1, block=True),
                                  tmp_path)
    assert (rec.op, rec.to_p) == ("scale_out", 2) and warm_ups
    steps = [s for s in spans if s[0] == "edl.step"]
    assert steps
    assert all(_inside(s, steps) for s in spans if s[0] != "edl.step")
    for step in steps:              # p 1 before the commit, 2 after it
        forwards = sum(s[0] == "edl.forward" and _inside(s, [step])
                       for s in spans)
        assert forwards in ((virtual,) if virtual else (1, 2))


def _switch(staged: bool):
    """A scale-out 1 -> 2, its state move staged behind the draining step
    or, with the staging turned off, inside the stop."""
    with _trainer(init_parallelism=1, remat=False) as t:
        t.step()
        if not staged:
            t._maybe_stage_switch = lambda: None
        return t.scale_out(1, block=True)


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "in_stop"])
def test_switch_counts_the_bytes_it_moves_inside_the_stop(staged):
    """A scale-out 1 -> 2 whose state move is staged behind the draining
    step counts its bytes as overlapped and none inside the stop; the same
    switch with the staging turned off moves the same bytes inside the
    stop. The count stays out of the summary the reference's records
    match."""
    rec = _switch(staged)
    assert (rec.op, rec.to_p) == ("scale_out", 2)
    assert (rec.t_stage_end > 0.0) == staged
    if staged:
        assert rec.bytes_moved_overlapped > 0 == rec.bytes_moved_in_stop
    else:
        assert rec.bytes_moved_in_stop > 0 == rec.bytes_moved_overlapped
    assert "bytes_moved_in_stop" not in rec.summary()


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "in_stop"])
def test_the_tracers_stop_window_carries_the_bytes_moved_inside_it(staged):
    """The switch's adjustment tree: a staged move's bytes on its
    ``staged_reshard`` span and none on its ``stop_window``; a move inside
    the stop has no ``staged_reshard`` and its bytes on the
    ``stop_window``."""
    rec = _switch(staged)
    tracer = Tracer()
    tracer.record_adjustment("job", rec)
    args = {s["name"]: s["args"] for s in tracer.spans}
    if staged:
        assert args["staged_reshard"] == {
            "bytes_moved": rec.bytes_moved_overlapped}
        assert args["stop_window"] == {}
    else:
        assert "staged_reshard" not in args
        assert args["stop_window"] == {"bytes_moved": rec.bytes_moved_in_stop}


def test_tracer_export_lands_on_the_profilers_epoch_clock(tmp_path):
    """One stretch recorded by the ``Tracer`` and by ``record_function``
    under the profiler: on the epoch clock (``ts + baseTimeNanoseconds /
    1e3``, both files) the two starts and ends lie within 1 ms."""
    tracer = Tracer()
    tracer.add_span("earlier", time.monotonic() - 1.0, time.monotonic())

    def both():
        with tracer.span("stretch"), \
                torch.profiler.record_function("stretch"):
            time.sleep(0.02)
    _, _, prof_trace = _profiled(both, tmp_path)
    ours = tracer.chrome_trace()

    def epoch_us(trace):
        e = next(e for e in trace["traceEvents"]
                 if e["name"] == "stretch" and e.get("ph") == "X")
        t0 = e["ts"] + trace["baseTimeNanoseconds"] / 1e3
        return t0, t0 + e["dur"]
    (a0, a1), (b0, b1) = epoch_us(ours), epoch_us(prof_trace)
    assert abs(a0 - b0) < 1e3 and abs(a1 - b1) < 1e3
    # the spans' own fields are as before: rebased to the earliest span
    first = min(e["ts"] for e in ours["traceEvents"])
    assert first == 0.0
