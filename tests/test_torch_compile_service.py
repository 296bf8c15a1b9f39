"""The port's compile service on the CPU: twins of the pure-service tests
of ``tests/test_compile_service.py`` against ``repro_torch``'s copy, a
trainer whose context prep runs as a ticket, the guard that a cached or
in-flight shape is never built again (with the build slowed on purpose),
and the profile sweep and the paper's job API on a live trainer."""
import threading
import time

import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

from repro_torch.configs import get_config
from repro_torch.core import EDLJob, ElasticTrainer
from repro_torch.core.compile_service import CANCELLED, DONE, FAILED, \
    PRIO_COMMITTED, PRIO_SPECULATIVE, CompileService
from repro_torch.core.profiling import profile


def _blocked_service(workers=1):
    """A service whose (single) worker is parked inside a blocker ticket —
    later submits stay PENDING until ``release`` fires, making dequeue
    order observable."""
    svc = CompileService(workers=workers)
    release = threading.Event()
    order = []

    def blocker():
        release.wait(10)
        return "blocked"

    svc.submit("blocker", blocker, priority=PRIO_COMMITTED)
    time.sleep(0.05)            # let the worker pick the blocker up
    return svc, release, order


# ------------------------------------------------------------- the queue
def test_committed_outranks_speculative():
    svc, release, order = _blocked_service()
    svc.submit("spec", lambda: order.append("spec"),
               priority=PRIO_SPECULATIVE)
    svc.submit("commit", lambda: order.append("commit"),
               priority=PRIO_COMMITTED)
    release.set()
    assert svc.drain(10)
    assert order == ["commit", "spec"], \
        "a committed prep must dequeue before any speculative one"
    svc.shutdown()


def test_cancel_pending_ticket_never_runs():
    svc, release, order = _blocked_service()
    t = svc.submit("doomed", lambda: order.append("ran"),
                   priority=PRIO_SPECULATIVE)
    assert svc.cancel("doomed") is True
    release.set()
    assert svc.drain(10)
    assert order == [] and t.state == CANCELLED and t.done()
    with pytest.raises(RuntimeError, match="cancelled"):
        t.result(1)
    assert svc.stats()["cancelled"] == 1
    svc.shutdown()


def test_dedup_and_escalation_compile_once():
    svc, release, order = _blocked_service()
    svc.submit("other", lambda: order.append("other"),
               priority=PRIO_SPECULATIVE)
    t1 = svc.submit("k", lambda: order.append("k"),
                    priority=PRIO_SPECULATIVE)
    t2 = svc.submit("k", lambda: order.append("k-dup"),
                    priority=PRIO_SPECULATIVE)
    assert t2 is t1, "a live key dedups to the same ticket"
    t3 = svc.submit("k", lambda: order.append("k-committed"),
                    priority=PRIO_COMMITTED)
    assert t3 is t1 and t1.priority == PRIO_COMMITTED \
        and not t1.speculative, "committed submit escalates in place"
    release.set()
    assert svc.drain(10)
    # escalated "k" outranks the earlier-queued speculative "other",
    # and the original fn runs exactly once
    assert order == ["k", "other"]
    s = svc.stats()
    assert s["deduped"] == 2 and s["escalated"] == 1
    svc.shutdown()


def test_cancel_owner_spares_committed_and_kept():
    svc, release, _ = _blocked_service()
    svc.submit(("s", 1), lambda: 1, priority=PRIO_SPECULATIVE, owner="o")
    svc.submit(("s", 2), lambda: 2, priority=PRIO_SPECULATIVE, owner="o")
    svc.submit(("c", 0), lambda: 3, priority=PRIO_COMMITTED, owner="o")
    svc.submit(("s", 3), lambda: 4, priority=PRIO_SPECULATIVE, owner="x")
    n = svc.cancel_owner("o", keep={("s", 1)})
    assert n == 1, "only the owner's un-kept speculative tickets cancel"
    assert svc.pending_keys("o") == {("s", 1), ("c", 0)}
    assert svc.pending_keys("x") == {("s", 3)}
    release.set()
    assert svc.drain(10)
    svc.shutdown()


def test_done_callback_fires_immediately_when_settled():
    svc = CompileService(workers=1)
    t = svc.submit("k", lambda: 42, priority=PRIO_COMMITTED)
    assert t.result(10) == 42 and t.state == DONE
    fired = []
    t.add_done_callback(lambda tk: fired.append(tk.value))
    assert fired == [42], "callbacks on settled tickets fire inline — " \
        "the speculative-hit path must not wait for a worker"
    svc.shutdown()


def test_failed_compile_surfaces_the_error():
    svc = CompileService(workers=1)

    def boom():
        raise ValueError("no such mesh")

    t = svc.submit("bad", boom, priority=PRIO_COMMITTED)
    assert t.wait(10) and t.state == FAILED
    with pytest.raises(ValueError, match="no such mesh"):
        t.result(1)
    assert svc.stats()["failed"] == 1
    svc.shutdown()


def test_two_preps_make_concurrent_progress():
    """Two committed tickets (two tenants re-targeting at once) must
    overlap in wall time — neither waits for the other's full compile."""
    svc = CompileService(workers=2)
    spans = {}

    def build(owner, dur=0.25):
        t0 = time.monotonic()
        time.sleep(dur)
        spans[owner] = (t0, time.monotonic())

    ta = svc.submit("a", lambda: build("a"), priority=PRIO_COMMITTED,
                    owner="job-a")
    tb = svc.submit("b", lambda: build("b"), priority=PRIO_COMMITTED,
                    owner="job-b")
    assert ta.wait(10) and tb.wait(10)
    (a0, a1), (b0, b1) = spans["a"], spans["b"]
    assert a0 < b1 and b0 < a1, \
        f"preps must overlap in wall time, got a={spans['a']} b={spans['b']}"
    svc.shutdown()


def test_drain_ignores_stale_heap_entries():
    """Cancelled (and escalation-duplicated) heap entries are lazy-deleted
    tombstones; drain must not wait on them."""
    svc, release, _ = _blocked_service()
    svc.submit("stale", lambda: None, priority=PRIO_SPECULATIVE)
    svc.cancel("stale")
    release.set()
    t0 = time.monotonic()
    assert svc.drain(5), "drain hung on a cancelled ticket's heap entry"
    assert time.monotonic() - t0 < 5
    assert svc.stats()["queued"] == 0
    svc.shutdown()


# ------------------------------------------------------ the port's trainer
def _trainer(**kw):
    args = dict(global_batch=8, seq_len=32, init_parallelism=1,
                n_samples=256, d_partitions=8, seed=0,
                devices=["cpu"] * 4, device="cpu", time_allowance_s=0)
    args.update(kw)
    return ElasticTrainer(get_config("edl-paper", smoke=True), **args)


def test_trainer_prep_runs_through_a_ticket():
    svc = CompileService(workers=1)
    with _trainer(compile_service=svc) as t:
        t.run(1)
        assert t.scale_out(1) is None
        ticket = t._prep_ticket
        assert ticket is not None and ticket.key == t._exec_key(2)
        assert t.join_prep(30) and ticket.state == DONE
        rec = t.wait_for_scaling()
        assert (rec.op, rec.to_p, t.p) == ("scale_out", 2, 2)
        assert rec.stop_time < rec.prep_time
    assert svc.stats()["compiled"] == 1
    svc.shutdown()


def test_cached_or_in_flight_shape_is_never_built_again():
    """ROADMAP C1's guard: with each build slowed by 0.3 s, a committed
    prep in flight, a second submit of its key, a direct build of the same
    shape from another thread, and a submit after it landed all end in the
    ONE build."""
    svc = CompileService(workers=2)
    builds = []
    with _trainer(compile_service=svc, use_aot=True) as t:
        warm = t._warm

        def slow_warm(devs):
            builds.append(len(devs))
            time.sleep(0.3)
            warm(devs)

        t._warm = slow_warm
        t.scale_out(1)
        first = t._prep_ticket
        key = t._exec_key(2)
        assert svc.submit(key, lambda: t._build_exec(2)) is first
        direct = []
        th = threading.Thread(target=lambda: direct.append(t._build_exec(2)))
        th.start()
        th.join(30)
        assert not th.is_alive()
        assert first.wait(30) and first.state == DONE
        again = svc.submit(key, lambda: t._build_exec(2),
                           priority=PRIO_COMMITTED)
        assert again.result(30) is first.value is direct[0]
        t.wait_for_scaling()
        assert t.p == 2
    assert builds == [2], builds
    svc.shutdown()


def test_profile_sweeps_feasible_p_and_restores_the_entry_p():
    with _trainer(init_parallelism=2) as t:
        table = profile(t, 1, 4, steps_per_p=2)
        assert sorted(p for p, _ in table.items()) == [1, 2, 4]
        assert t.p == 2 and len(t.worker_ids) == 2
        assert all(pt.throughput > 0 for _, pt in table.items())
        assert max(pt.efficiency for _, pt in table.items()) == 1.0


def test_edl_job_api_reaches_the_trainer():
    with _trainer() as t:
        job = EDLJob("job-api", t)
        assert EDLJob.get("job-api") is job
        t.run(1)
        job.scale_out(1, block=True)
        assert t.p == 2
        job.sclae_out(2, block=True)
        assert t.p == 4
        job.sclae_in(2, block=True)
        assert t.p == 2
        victim = t.worker_ids[-1]
        job.scale_in([victim], block=True)
        assert t.p == 1 and victim not in t.worker_ids
        assert list(job.profile().entries) == [1]
