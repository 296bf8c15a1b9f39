"""Whole runs of the harness on the CPU at small sizes: the result's keys,
the import check, and ``correct`` coming out false for each fault that a
training cell can have, planted in the program underneath the harness."""
import json
import subprocess
import sys
import time

import pytest
import torch

from edlbench import run

from helpers import switching_files, tiny_files

CPU = [torch.device("cpu")]
KW = {"time_allowance_s": 0}      # a switch commits at the next step


def go(workload, fault=None, seed=2**31 + 17, files=None, **kw):
    files = files or tiny_files(workload, **kw)
    return run.run_cell(files, seed, 0.5, False, CPU, trainer_kw=KW,
                        t_start=time.monotonic(), fault=fault)


@pytest.mark.parametrize("workload", ["phi3.b2x8k"])
def test_result_line(workload):
    out = go(workload)
    res = out["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    json.dumps(res)
    files = run.cell_files(workload)
    assert set(res["metrics"]) == {m["name"] for m in files["end_to_end"]}
    for m in files["end_to_end"]:
        assert res["metrics"][m["name"]]["unit"] == m["unit"]
        assert res["metrics"][m["name"]]["value"] > 0
    assert set(res["compared"]) == set(files["limits"])
    assert all(set(c) == {"value", "limit"}
               for c in res["compared"].values())
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["compared"]["data_repeats"]["value"] == 0
    assert out["forbidden"] == []
    assert res["correct"], res["compared"]     # fp32 here: gaps to rounding


def test_a_mix_that_switches():
    """Scale ops in a mix: Busy retried, both shapes warmed in set-up, the
    checked steps across both switches held against the reference, every
    stop inside the step that committed it."""
    out = go("phi3.b2x8k", files=switching_files())
    res = out["result"]
    assert res["correct"], res["compared"]
    assert res["compared"]["stops_outside_step"]["value"] == 0
    sw = out["run"]["switches"]
    assert {(s["from_p"], s["to_p"]) for s in sw} == {(4, 2), (2, 4)}
    assert all(s["inside_step"] and s["staged"] for s in sw)
    assert {s["p"] for s in out["run"]["window"]["steps"]} == {2, 4}


def test_forbidden_modules_are_found_by_whole_top_level_name(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert run.forbidden_modules() == ["jax", "repro"]


def test_no_card_no_result():
    """Without a card the harness exits with another code than 0 and
    prints nothing on standard output."""
    p = subprocess.run([sys.executable, str(run.HERE / "run.py"),
                        "--workload", "phi3.b2x8k", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout == ""


def wrap_step(trainer, fn):
    orig = trainer.exec.step_fn
    trainer.exec.step_fn = lambda state, batch: fn(orig, state, batch)


def unchanged(trainer):
    def f(orig, state, batch):
        _, metrics = orig(state, batch)
        return state, metrics
    wrap_step(trainer, f)


def half_batch(trainer):
    def f(orig, state, batch):
        return orig(state, {k: v[:len(v) // 2] for k, v in batch.items()})
    wrap_step(trainer, f)


def row_altered(trainer):
    """The data layer hands the step a first row other than the one its
    sample id names."""
    data = trainer.dataset
    read = data.read

    def altered(start, count):
        out = read(start, count)
        for k in ("tokens", "labels"):
            out[k][0] = (out[k][0] + 1) % data.vocab
        return out
    data.read = altered


@pytest.mark.parametrize("fault", [unchanged, half_batch, row_altered])
def test_fault_makes_correct_false(fault):
    assert go("phi3.b2x8k", seq_len=64)["result"]["correct"]
    assert not go("phi3.b2x8k", fault, seq_len=64)["result"]["correct"]


@pytest.mark.parametrize("key, value", [("sliding_window", 4096),
                                        ("rope_scaling", {"type": "longrope"}),
                                        ("decay_lora", 32)])
def test_port_config_refuses_what_the_port_would_not_run(key, value):
    files = tiny_files("phi3.b2x8k")
    m = files["model"]
    run.port_config(m)
    if key == "decay_lora":
        m = run.load_json(run.HERE / "configs" / "rwkv6-1.6b.json")
        run.port_config(m)
    with pytest.raises(ValueError, match=key):
        run.port_config(dict(m, **{key: value}))


def test_step_mfu_reads_the_untraced_steps():
    """The profiler's slower steps do not enter the whole step's share."""
    from edlbench import counts, readers
    files = tiny_files("phi3.b2x8k")
    L = files["traffic"]["seq_len"]
    tokens = 2 * L

    def steps(*seconds):
        return [{"t0": 0.0, "t1": s, "p": 1, "tokens": tokens}
                for s in seconds]
    rec = {"model": files["model"], "traffic": files["traffic"],
           "chips": 1, "trace": {"busy_s": {0: 1.0}, "window_s": 9.0},
           "trace_steps": steps(3.0, 3.0, 3.0),
           "untraced_steps": steps(1.0, 1.0)}
    want = (100.0 * counts.step_model_flops(files["model"], 2, L)
            / counts.PEAK_BF16_FLOPS)
    assert readers.step_mfu(rec) == pytest.approx(want)
    assert readers.step_mfu(dict(rec, trace=None)) is None
    assert readers.step_mfu(dict(rec, untraced_steps=[])) is None


def test_every_metric_has_its_reader():
    """Each metric of ``BENCHMARK.json`` has a reader file whose layer and
    moved metric are those the benchmark gives."""
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    for m in bench["end_to_end"]:
        assert callable(run.reader(m["name"]).read), m["name"]
    for m in bench["per_layer"]:
        mod = run.reader(m["name"])
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"]), m["name"]
