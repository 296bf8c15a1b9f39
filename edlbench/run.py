#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port, one cell a run.

    python3 edlbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the limits of its comparison
(``limits/<cell>.json``) and one reader for each metric it reports
(``metrics/<metric>.py``). A run is one process on the cards it asks for:

1. set-up: build the port's ``ElasticTrainer`` (its context prep warms the
   step's shape), run the mix's ``warm`` ops (the other shapes its window
   switches to), land the benchmark's weights (``reference.model.
   init_params``, drawn on the card from the seed) as its train state, and
   run the ``checked`` ops, whose first ``reference_steps`` steps the
   reference follows;
2. the window: the mix's ``cycle`` of ops (``step``, ``scale_in``,
   ``scale_out``), whole cycles until ``--seconds`` have passed; with
   ``--trace 1`` a stretch of it under ``torch.profiler``, whose trace
   (``trace.py``) the per-layer readers take, the program's own ``edl.*``
   spans with it;
3. once the window has closed and the program's state is freed, the
   reference, and the comparison (``check.py``) against the limits.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number compared beside its
limit, which the last lines of standard error repeat. The line before it
holds what the run saw besides (the losses, each card's peak, the mean
step, with ``--trace 1`` the device time by span). Without enough
cards, with the program missing, or with JAX or the JAX package loaded, it
exits with another code than 0 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse      # noqa: E402
import contextlib    # noqa: E402
import gc            # noqa: E402
import importlib.util  # noqa: E402
import json          # noqa: E402
import math          # noqa: E402
import os            # noqa: E402
import subprocess    # noqa: E402
import sys           # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the keys of a configuration file that are the benchmark's own, besides
# those that begin with ``reference_`` (the reference's chunk sizes)
OWN_KEYS = {"source", "arch", "model", "torch_dtype", "reduced", "published",
            "assumed", "deployment"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str) -> dict:
    """The cell's entry in ``BENCHMARK.json`` and the files it names."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def applies(metric):
        return "workloads" not in metric or workload in metric["workloads"]
    return {"cell": w,
            "model": load_json(ROOT / cfg["file"]),
            "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{workload}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def reader(name: str):
    """The module of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"edlbench_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def port_config(model: dict):
    """The port's ``ArchConfig`` of the benchmark's configuration: the
    port's published config with the file's values, each set on the field
    its kind's ``PORT_FIELDS`` names (``mla.kv_lora``: a field of the
    nested config). A key that the port would not run as the file
    states it is refused: one it has no field for, or a value other than
    the one it fixes (the kind's ``fixed``)."""
    from edlbench.reference import kind
    from repro_torch.configs import get_config
    k = kind(model)
    fixed = k.fixed(model)
    unknown = sorted(
        key for key in set(model) - set(k.PORT_FIELDS) - OWN_KEYS
        - set(fixed) if not key.startswith("reference_"))
    wrong = sorted(key for key in fixed if key in model
                   and model[key] != fixed[key])
    if unknown or wrong:
        raise ValueError(f"the port does not run these keys as the "
                         f"configuration states them: {unknown + wrong}")
    fields = {f: model[key] for key, f in k.PORT_FIELDS.items()
              if key in model}
    fields["param_dtype"] = fields["compute_dtype"] = model["torch_dtype"]
    return _replace(get_config(model["arch"]), fields)


def _replace(obj, fields: dict):
    """The dataclass ``obj`` with ``fields`` set; a dotted name sets a field
    of the nested dataclass its first part names."""
    import dataclasses
    top, inner = {}, {}
    for name, value in fields.items():
        head, _, rest = name.partition(".")
        if rest:
            inner.setdefault(head, {})[rest] = value
        else:
            top[name] = value
    for head, sub in inner.items():
        child = getattr(obj, head)
        if child is None:
            raise ValueError(f"the port's {type(obj).__name__} has no "
                             f"{head!r} to set {sorted(sub)} in")
        top[head] = _replace(child, sub)
    return dataclasses.replace(obj, **top)


def power_limits(n: int) -> list:
    """Each card's power limit in W, from ``nvidia-smi``; None where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return [float(x) for x in out[:n]]
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return [None] * n


class Runner:
    """Drives the trainer through a mix's ops, records every call it makes
    into the port as a span, and each step's rows; a step's record keeps
    every number ``step()`` returned (``values``: the loss, the gradient's
    norm and the program's counters, already on the host)."""

    def __init__(self, trainer, traffic: dict, profile_fn=None):
        self.trainer = trainer
        self.tokens = traffic["global_batch"] * traffic["seq_len"]
        self.spans: list[dict] = []
        self.steps: list[dict] = []
        self.ids: list = []
        self.profile_fn = profile_fn or (lambda name: contextlib.nullcontext())

    @contextlib.contextmanager
    def span(self, name: str):
        rec = {"name": name, "t0": time.monotonic()}
        with self.profile_fn(f"edlbench.{name}"):
            yield rec
        rec["t1"] = time.monotonic()
        self.spans.append(rec)

    def step(self) -> dict:
        from repro_torch.core.scaling import Phase
        p = self.trainer.p
        with self.span("step") as rec:
            out = self.trainer.step()
        if out is None:
            raise RuntimeError("the data pipeline ran dry inside a run")
        self.ids.append(self.trainer._last_sample_ids.copy())
        rec.update(p=p, tokens=self.tokens, values=dict(out),
                   idle=self.trainer.controller.phase is Phase.IDLE)
        self.steps.append(rec)
        return rec

    def op(self, op: dict):
        from repro_torch.core.scaling import Busy, Phase
        kind = op["op"]
        if kind == "step":
            return self.step()
        if kind == "settle":
            while self.trainer.controller.phase is not Phase.IDLE:
                self.step()
            return None
        if kind not in ("scale_in", "scale_out"):
            raise ValueError(f"unknown op {kind!r}")
        while True:     # Busy (the paper's RETRY) is retried a step later
            try:
                with self.span(kind):
                    if kind == "scale_in":
                        self.trainer.scale_in(op["n"], release=False)
                    else:
                        self.trainer.scale_out(op["n"])
                return None
            except Busy:
                self.step()


def leaf_norms(tree: dict, prefix: str, scale: float = 1.0) -> dict:
    """Float64 norm of each leaf under ``prefix`` of a nested tree,
    keyed by its path below it."""
    from repro_torch.models.params import tree_leaves
    out = {}
    for path, t in tree_leaves(tree):
        if path.startswith(prefix):
            out[path[len(prefix):]] = math.sqrt(
                float(t.double().square().sum())) * scale
    return out


def build(files: dict, seed: int, devices: list, *, trainer_kw=None,
          profile_fn=None):
    """The cell's trainer on ``devices`` (its slots spread over them) fed by
    the benchmark's token stream, and its runner."""
    from edlbench.data import TokenStream
    from repro_torch.core import ElasticTrainer
    from repro_torch.optim import adamw
    model, traffic = files["model"], files["traffic"]
    o = traffic["optimizer"]
    optimizer = adamw(o["lr"], o["b1"], o["b2"], o["eps"], o["weight_decay"])
    data = TokenStream(traffic["n_samples"], traffic["seq_len"],
                       model["vocab_size"], seed)
    slots = traffic["slots"]
    pool = [devices[i * len(devices) // slots] for i in range(slots)]
    t0 = time.monotonic()
    trainer = ElasticTrainer(
        port_config(model), global_batch=traffic["global_batch"],
        seq_len=traffic["seq_len"], init_parallelism=traffic["init_p"],
        optimizer=optimizer, dataset=data, n_samples=traffic["n_samples"],
        d_partitions=traffic["n_samples"] // traffic["partition_samples"],
        seed=seed, devices=pool, device=devices[0].type,
        **(trainer_kw or {}))
    drv = Runner(trainer, traffic, profile_fn)
    drv.spans.append({"name": "ElasticTrainer", "t0": t0,
                      "t1": time.monotonic()})
    return trainer, drv


def start(files: dict, seed: int, devices: list, *, trainer_kw=None,
          profile_fn=None):
    """``build``, then the mix's ``warm`` ops: the other shapes its window
    switches to."""
    trainer, drv = build(files, seed, devices, trainer_kw=trainer_kw,
                         profile_fn=profile_fn)
    for op in files["traffic"]["warm"]:
        drv.op(op)
    return trainer, drv


def land(trainer, model: dict, seed: int):
    """The benchmark's weights of ``seed`` (the reference's start), fresh
    AdamW state and step 0, as the trainer's train state on its layout."""
    import torch
    from edlbench.reference import model as ref
    from repro_torch.models.params import tree_unflatten
    from repro_torch.reshape import place_state
    home = trainer.exec.devices[0]
    trainer.state = None
    gc.collect()
    params = tree_unflatten(ref.init_params(model, seed, home).items())
    whole = {"params": params, "opt": trainer.optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=home)}
    trainer.state = place_state(trainer.exec.layout, whole,
                                trainer.exec.devices)


def checked(drv, files: dict, seed: int, fault=None) -> tuple[dict, list]:
    """The mix's checked ops from the weights and rows of ``seed``, landed
    on the trainer (``fault``, a test's, is then called with it): the
    program's loss at each of the first ``reference_steps`` steps, its
    first gradient's norm of each leaf (its first moment after one step,
    over 1 - b1) and each leaf's change after the last of them; and those
    steps' sample ids."""
    from edlbench.reference import model as ref
    from repro_torch.models.params import tree_leaves
    trainer, model = drv.trainer, files["model"]
    trainer.dataset.seed = seed
    land(trainer, model, seed)
    if fault is not None:
        fault(trainer)
    b1 = files["traffic"]["optimizer"]["b1"]
    n = files["traffic"]["reference_steps"]
    home = trainer.exec.devices[0]
    first = len(drv.steps)
    prog = {"loss": [], "grad_norm": {}, "change_norm": {}}
    for op in files["traffic"]["checked"]:
        rec = drv.op(op)
        k = len(drv.steps) - first
        if rec is None or k > n:
            continue
        prog["loss"].append(rec["values"]["loss"])
        if k == 1:
            prog["grad_norm"] = leaf_norms(trainer.whole_state(home),
                                           "opt/mu/", 1.0 / (1.0 - b1))
        if k == n:
            start = ref.init_params(model, seed, home)
            prog["change_norm"] = {
                path: math.sqrt(float((t.double() - start[path].double())
                                      .square().sum()))
                for path, t in tree_leaves(
                    trainer.whole_state(home)["params"])}
            del start
    if len(drv.steps) - first < n:
        raise RuntimeError(f"the mix's checked ops ran fewer than {n} "
                           "steps")
    return prog, drv.ids[first:first + n]


def reference_batches(ids: list, files: dict, seed: int) -> list:
    """The (tokens, labels) of each checked step's rows, rebuilt from
    their sample ids."""
    import torch
    from edlbench.data import tokens_of
    L = files["traffic"]["seq_len"]
    out = []
    for b in ids:
        toks = torch.from_numpy(tokens_of(b, L, files["model"]["vocab_size"],
                                          seed))
        out.append((toks[:, :-1].contiguous(), toks[:, 1:].contiguous()))
    return out


def run_cell(files: dict, seed: int, seconds: float, trace: bool,
             devices: list, *, trainer_kw=None, t_start=None,
             fault=None) -> dict:
    """One run of a cell on ``devices`` (one torch device a card of the
    cell); returns its result and its record. ``fault`` (a test's) is
    called with the trainer once its state has landed."""
    import numpy as np
    import torch
    from edlbench import check, trace as trace_mod
    from edlbench.reference import model as ref

    t_start = T_START if t_start is None else t_start
    model, traffic, limits = files["model"], files["traffic"], files["limits"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = devices[0].type == "cuda"
    home = devices[0]
    o = traffic["optimizer"]

    # ---------------------------------------------------------- set-up
    prof_state = {"on": False}

    def profile_fn(name):
        if prof_state["on"]:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()
    trainer, drv = start(files, seed, devices, trainer_kw=trainer_kw,
                         profile_fn=profile_fn)
    n_warm = len(drv.steps)
    prog, checked_ids = checked(drv, files, seed, fault)
    n_checked = len(drv.steps)
    while trainer.controller.phase.value != "idle":
        drv.step()
    gc.collect()
    if cuda:
        for d in devices:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)

    # ---------------------------------------------------------- window
    setup_s = time.monotonic() - t_start
    cycle = traffic["cycle"]
    t_from, t_units = traffic["trace_from"], traffic["trace_units"]
    need = t_from + t_units if trace else 1
    prof = None
    trace_span = None
    units = 0
    w0 = time.monotonic()
    first = len(drv.steps)
    while True:
        if trace and units == t_from:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]
                + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []))
            prof.__enter__()
            prof_state["on"] = True
            trace_span = torch.profiler.record_function("edlbench.window")
            trace_span.__enter__()
            trace_first = len(drv.steps)
        for op in cycle:
            drv.op(op)
        units += 1
        if trace and units == t_from + t_units:
            trace_span.__exit__(None, None, None)
            prof_state["on"] = False
            prof.__exit__(None, None, None)
            trace_last = len(drv.steps)
        if units >= need and time.monotonic() - w0 >= seconds:
            break
    w1 = drv.steps[-1]["t1"]
    window_steps = drv.steps[first:]

    # ------------------------------------------- after the window closed
    peaks = ([torch.cuda.max_memory_allocated(d) for d in devices] if cuda
             else [0] * len(devices))
    records = [r for r in trainer.controller.history
               if r.t_switch_start >= w0]
    ids = np.concatenate(drv.ids)
    spans = list(drv.spans)
    trainer.close()
    del trainer, drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()

    def inside(r):
        return any(s["name"] == "step" and s["t0"] <= r.t_switch_start
                   and r.t_switch_end <= s["t1"] for s in spans)
    switches = [{"op": r.op, "from_p": r.from_p, "to_p": r.to_p,
                 "prep_s": r.prep_time, "stop_s": r.stop_time,
                 "bytes_moved_overlapped": r.bytes_moved_overlapped,
                 "staged": r.t_stage_end > 0.0, "inside_step": inside(r)}
                for r in records]
    run = {"model": model, "traffic": traffic, "chips": len(devices),
           "setup_s": setup_s,
           "window": {"seconds": w1 - w0, "steps": window_steps,
                      "tokens": sum(s["tokens"] for s in window_steps)},
           "switches": switches, "trace": None, "trace_steps": None,
           "untraced_steps": window_steps}
    out_dir = ROOT / "build" / "edlbench"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"spans-{files['cell']['name']}.json", "w") as f:
        json.dump({"seed": seed, "spans": spans, "switches": switches}, f)
    if trace:
        path = out_dir / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        try:
            run["trace"] = trace_mod.load(str(path))
        finally:
            path.unlink(missing_ok=True)
        run["trace_steps"] = window_steps[trace_first - first:
                                          trace_last - first]
        run["untraced_steps"] = (window_steps[:trace_first - first]
                                 + window_steps[trace_last - first:])

    # ------------------------------------------------------ the reference
    t_ref = time.monotonic()
    reference = ref.train(model, o, seed,
                          reference_batches(checked_ids, files, seed),
                          devices, rows=traffic["reference_rows"])
    ref_s = time.monotonic() - t_ref
    cmp = check.compare(prog, reference, set(limits))
    values = dict(cmp["values"])
    if "data_repeats" in limits:
        values["data_repeats"] = int(len(ids) - len(np.unique(ids)))
    if "stops_outside_step" in limits:
        values["stops_outside_step"] = sum(not s["inside_step"]
                                           for s in switches)
    compared = {k: {"value": values[k], "limit": lim}
                for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())

    kind = "end_to_end" if not trace else "per_layer"
    metrics = {}
    for m in files[kind]:
        v = reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else home.type,
              "kind": torch.cuda.get_device_name(home) if cuda else "cpu",
              "count": len(devices), "memory_peak_bytes": max(peaks),
              "power_limit_w": power_limits(len(devices)) if cuda else []}
    result = {"correct": correct, "attempted": len(window_steps),
              "failed": 0, "metrics": metrics, "device": device}
    if trace and run["trace"]:
        tr = run["trace"]
        busy = [tr["busy_s"].get(d.index, 0.0) for d in devices] if cuda \
            else [0.0]
        device.update(busy_s=sum(busy) / len(devices),
                      window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["top_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["compared"] = compared
    return {"result": result, "run": run, "peaks": peaks, "spans": spans,
            "forbidden": found, "compare": cmp, "reference_s": ref_s,
            "program": prog, "reference": reference,
            "n_steps": {"warm": n_warm, "checked": n_checked - n_warm,
                        "window": len(window_steps)}}


# the trace's span keys the run prints beside its result (``trace.py``)
SPAN_KEYS = ("span_device_s", "span_group_s", "span_kernels",
             "span_within_s", "span_host_s", "idle_by_span",
             "launch_host_s", "host_own_s")


def step_seconds(run: dict) -> dict:
    """The mean host seconds of a window step, traced and untraced: what
    the profiler costs a step."""
    def mean(steps):
        return (sum(s["t1"] - s["t0"] for s in steps) / len(steps)
                if steps else None)
    return {"traced": mean(run["trace_steps"] or []),
            "untraced": mean(run["untraced_steps"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    files = cell_files(args.workload)
    set_cache_dirs()
    import torch
    chips = files["cell"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"this cell needs {chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 4
    devices = [torch.device(f"cuda:{i}") for i in range(chips)]
    out = run_cell(files, args.seed, args.seconds, bool(args.trace), devices)
    if out["forbidden"]:
        print(f"JAX or the JAX package was loaded: {out['forbidden']}",
              file=sys.stderr)
        return 5
    res = out["result"]
    tr = out["run"]["trace"] or {}
    print(json.dumps({"memory_peak_bytes_per_card": out["peaks"],
                      "steps": out["n_steps"],
                      "reference_s": out["reference_s"],
                      "program": out["program"]["loss"],
                      "reference": out["reference"]["loss"],
                      "worst_leaf": out["compare"]["worst_leaf"],
                      "step_s": step_seconds(out["run"]),
                      "switches": out["run"]["switches"],
                      "spans": {k: tr.get(k) for k in SPAN_KEYS}}),
          flush=True)
    for k, c in res["compared"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
