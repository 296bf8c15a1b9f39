"""Multi-tenant cluster driver (end-to-end example + integration target).

Runs N concurrent elastic jobs on a shared device pool under a pluggable
scheduling policy, reporting per-job JCTs, all scaling events (including
checkpoint-stop preemptions and re-admissions), and the
device-conservation verdict as JSON, with the reference driver's job
grammar, flags and JSON keys. ``--devices N`` counts logical slots (several
share a card when there is one); ``--device cpu`` runs every slot on the
CPU, and the default, ``cuda``, fails without a card. Tenants train their
arch at its SMOKE width (the reference's ``default_trainer_factory``).

  python -m repro_torch.launch.cluster --devices 4 \
      --policy throughput --jobs "a=vgg19:3:25@0,b=resnet50:1:30@0"

  # Tiresias-style preemptive time-sharing: a higher-priority arrival
  # checkpoint-stops the running tenant to disk and re-admits it later
  python -m repro_torch.launch.cluster --devices 4 \
      --policy tiresias --quanta 0.1,1000 \
      --jobs "a=resnet50:2:20@0,b=vgg19:4:12@6"

  # schedule from LIVE measured curves instead of the analytic priors,
  # prefilled by profiling sweeps on idle devices (EDL §5.2)
  python -m repro_torch.launch.cluster --devices 4 \
      --policy throughput --throughput-model measured --profile-sweeps

  # Philly-like arrival trace synthesized onto live jobs
  python -m repro_torch.launch.cluster --devices 4 \
      --workload "trace=philly seed=0 jobs=6 steps=4:10"

Job grammar:
``name=profile:requested_p:total_steps[:mp=M|mp=auto][:vw=K]@arrival``
where ``profile`` names an analytic scaling profile
(sched.throughput.PROFILES — the ThroughputModel's prior), ``arrival`` is
in scheduling rounds, and the optional ``mp=M`` field makes the tenant
model-parallel: ``requested_p`` then counts 2-D mesh *device groups* of M
devices each (one data-parallel replica per group), and the executor
grants/reclaims whole groups. Example — one mp=2 tenant packing against
two mp=1 tenants on 4 devices:

  python -m repro_torch.launch.cluster --devices 4 \
      --jobs "big=vgg19:1:12:mp=2@0,a=resnet50:1:16@0,b=googlenet:1:10@0"

``mp=auto`` leaves the degree to the scheduler instead: the tenant
launches data-parallel and reshape-aware policies (elastic-tiresias,
throughput) may RESHAPE it live — trading data-parallel for
model-parallel degree at a mini-batch boundary, stop-free — as pool
pressure and its measured/analytic curve dictate:

  python -m repro_torch.launch.cluster --devices 4 \
      --policy elastic-tiresias \
      --jobs "flex=vgg19:4:20:mp=auto@0,b=googlenet:2:10@4"

Alternatively ``--workload`` synthesizes the job list from
sched.workload's trace generators (keys: trace=philly|synthetic, seed,
jobs, steps=LO:HI, mp=1:2 — colon-separated model-parallel degrees drawn
per job for a mixed-mp population; the degree ``auto`` draws
reshape-able tenants).

A ``serve=TRACE`` tenant is a serving replica set (the serving tier,
``repro_torch.cluster.serving``) whose demand follows the request-rate
trace; any serving tenant wraps the policy in ``CrossTierPolicy``, so a
lull loans its slots to training and a spike reclaims them stop-free:

  python -m repro_torch.launch.cluster --devices 4 --policy throughput \
      --jobs "api=resnet50:1:12:serve=4/4/4/16/16/16/16/16/16/4/4/4:cap=4\
:max=3@0,t=resnet50:1:40@0"

``--compile-cache DIR`` builds the port's CUDA kernel libraries into DIR
and reuses them from there (``cluster.executor.enable_compile_cache``): the
port compiles nothing per topology, so the libraries are all the cache
holds.
"""
import argparse
import json
import sys
import time

def parse_jobs(text: str, *, batch: int, seq: int, n_samples: int,
               d_partitions: int, default_mp: int = 1):
    """``name=profile:requested_p:total_steps[:mp=M|mp=auto][:vw=K]@arrival``
    — fields after the first three are ``key=value`` (extensible); ``mp``
    sets the tenant's model-parallel degree (devices per allocation
    group). ``mp=auto`` leaves the degree to the scheduler: the tenant
    launches data-parallel and reshape-aware policies may re-target its
    degree live (the RESHAPE verb). ``vw=K`` (or ``vw=auto``) opts the
    tenant into deterministic elasticity: K fixed virtual workers make
    every resize the scheduler applies bitwise trajectory-preserving
    (every dp must divide K). ``default_mp`` applies to jobs without an
    explicit ``mp=`` (the bench's --model-parallel knob).

    ``serve=TRACE`` makes the tenant a SERVING job instead (tier
    "serving", repro_torch.cluster.serving): TRACE is ``diurnal`` /
    ``spike`` / ``flat`` or a literal ``/``-separated rate list;
    ``requested_p`` becomes the reserved replica count, ``total_steps`` the
    trace length in served rounds. Serving knobs (all ``key=value``
    extras): ``slo=MS`` (p99 SLO, default 250), ``cap=R`` (requests per
    replica per wave), ``peak=``/``base=``/``period=`` (trace synthesis),
    ``min=``/``max=`` (replica bounds), ``arch=`` (model config; also valid
    on training jobs)."""
    from repro_torch.cluster.job import JobSpec
    specs = []
    for i, item in enumerate(text.split(",")):
        name, rest = item.split("=", 1)
        body, _, arrival = rest.partition("@")
        profile, req_p, steps, *extras = body.split(":")
        mp, mp_auto = default_mp, False
        vw: int | str = 0
        serve = None
        arch = None
        trace_kw: dict = {}
        serve_kw: dict = {}
        for extra in extras:
            key, eq, val = extra.partition("=")
            if key == "mp" and eq and val == "auto":
                mp, mp_auto = 1, True
            elif key == "mp" and eq:
                mp = int(val)
            elif key == "vw" and eq:
                vw = val if val == "auto" else int(val)
            elif key == "serve" and eq:
                serve = val
            elif key == "arch" and eq:
                arch = val
            elif key == "slo" and eq:
                serve_kw["slo_ms"] = float(val)
            elif key == "cap" and eq:
                serve_kw["replica_capacity"] = int(val)
            elif key == "min" and eq:
                serve_kw["min_replicas"] = int(val)
            elif key == "max" and eq:
                serve_kw["max_replicas"] = int(val)
            elif key in ("peak", "base") and eq:
                trace_kw[key] = float(val)
            elif key == "period" and eq:
                trace_kw["period"] = int(val)
            else:
                raise ValueError(
                    f"job {name!r}: unknown spec field {extra!r} "
                    f"(supported: mp=M, mp=auto, vw=K, vw=auto, arch=A, "
                    f"serve=TRACE, slo=MS, cap=R, min=P, max=P, peak=X, "
                    f"base=X, period=N)")
        common = dict(
            name=name.strip(), profile=profile, requested_p=int(req_p),
            total_steps=int(steps), arrival=float(arrival or 0.0),
            global_batch=batch, seq_len=seq, n_samples=n_samples,
            d_partitions=d_partitions, seed=i)
        if arch is not None:
            common["arch"] = arch
        if serve is not None:
            if vw or mp_auto:
                raise ValueError(f"job {name!r}: serve= is incompatible "
                                 f"with vw= and mp=auto")
            from repro_torch.cluster.serving import ServingSpec
            from repro_torch.sched.traffic import parse_trace
            trace = parse_trace(serve, rounds=int(steps), **trace_kw)
            specs.append(ServingSpec(model_parallel=mp, trace=trace,
                                     **serve_kw, **common))
            continue
        if serve_kw or trace_kw:
            bad = sorted(set(serve_kw) | set(trace_kw))
            raise ValueError(f"job {name!r}: serving knobs {bad} need "
                             f"serve=TRACE")
        specs.append(JobSpec(model_parallel=mp, mp_auto=mp_auto,
                             virtual_workers=vw, **common))
    return specs


def parse_workload(text: str, *, devices: int, batch: int, seq: int,
                   n_samples: int, d_partitions: int):
    """``--workload "trace=philly seed=0 jobs=6 steps=4:10"`` — synthesize
    live JobSpecs from the sched.workload trace generators (which
    previously only fed the discrete-event simulator)."""
    from repro_torch.sched import workload
    tokens = [item for item in text.replace(",", " ").split() if item]
    bad = [t for t in tokens if "=" not in t]
    if bad:
        raise ValueError(f"--workload tokens must be key=value, got {bad}; "
                         f"keys: trace, seed, jobs, steps, mp")
    kv = dict(t.split("=", 1) for t in tokens)
    trace = kv.get("trace", "philly")
    seed = int(kv.get("seed", 0))
    n_jobs = int(kv.get("jobs", 6))
    lo, _, hi = kv.get("steps", "4:20").partition(":")
    steps = (int(lo), int(hi or lo))
    # mp=1:2 — colon-separated model-parallel degrees drawn per trace job;
    # the degree "auto" draws reshape-able (mp=auto) tenants
    mp_choices = tuple(m if m == "auto" else int(m)
                       for m in kv.get("mp", "1").split(":"))
    if trace == "philly":
        jobs = workload.philly_like(seed=seed, n_jobs=n_jobs,
                                    mp_choices=mp_choices)
    elif trace == "synthetic":
        jobs = workload.synthetic_16(seed=seed, n_jobs=n_jobs,
                                     mp_choices=mp_choices)
    else:
        raise ValueError(f"unknown trace {trace!r}; philly or synthetic")
    return workload.to_cluster_specs(
        jobs, devices=devices, batch=batch, steps=steps, seq_len=seq,
        n_samples=n_samples, d_partitions=d_partitions)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", default="a=vgg19:3:25@0,b=resnet50:1:30@0,"
                                      "c=googlenet:1:15@6")
    ap.add_argument("--policy", default="throughput",
                    choices=["tiresias", "elastic-tiresias", "throughput",
                             "static"])
    ap.add_argument("--quanta", default=None,
                    help="comma-separated Tiresias service quanta in "
                         "attained GPU-seconds, e.g. '0.1,1000' (Tiresias "
                         "policies only)")
    ap.add_argument("--workload", default=None,
                    help="synthesize jobs from a sched.workload trace "
                         "instead of --jobs, e.g. 'trace=philly seed=0 "
                         "jobs=6 steps=4:10'")
    ap.add_argument("--throughput-model", default="analytic",
                    choices=["analytic", "measured"],
                    help="what policies schedule from: the static analytic "
                         "t(p) curves, or per-job measured curves fed by "
                         "live step times (analytic prior fallback)")
    ap.add_argument("--profile-sweeps", action="store_true",
                    help="prefill measured curves by running EDL-profile "
                         "scale-in sweeps on idle devices (measured model "
                         "only)")
    ap.add_argument("--profile-ttl", type=float, default=None,
                    metavar="ROUNDS",
                    help="staleness TTL for profile sweeps: re-sweep a job "
                         "once its measured curve is this many rounds old "
                         "(default: sweep each job at most once)")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="persistent cache of the CUDA kernel libraries: "
                         "built into DIR once, reused across rounds, "
                         "preemptions and reruns")
    ap.add_argument("--prefetch-shapes", action="store_true",
                    help="speculatively compile each job's likely-next "
                         "shapes (sched.base.likely_next_shapes) on idle "
                         "compile-service threads so a later committed "
                         "resize/RESHAPE finds a warm exec handle")
    ap.add_argument("--compile-workers", type=int, default=2,
                    metavar="N",
                    help="compile-service pool size: how many background "
                         "context preps may run concurrently (default 2)")
    ap.add_argument("--serialize-prep", action="store_true",
                    help="legacy small-host throttle: one context prep at "
                         "a time cluster-wide, no compile service (the "
                         "pre-priority-queue behavior)")
    ap.add_argument("--faults", default=None, metavar="PATH_OR_SPEC",
                    help="fault-injection plan replayed against the run: "
                         "a FaultPlan JSON trace file, or an inline "
                         "'random:seed=0,kills=1,revokes=1,rounds=40' "
                         "spec (repro_torch.chaos)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace-event JSON of every "
                         "committed adjustment's span tree (plan/prep/"
                         "drain/stop-window), checkpoint save and fault "
                         "recovery — load it in chrome://tracing or "
                         "https://ui.perfetto.dev")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the run's telemetry stream as JSONL: "
                         "every typed bus event plus periodic metric "
                         "snapshots (validate/render it with "
                         "tools/obs_report.py)")
    ap.add_argument("--prom-port", type=int, default=None, metavar="PORT",
                    help="serve the metrics registry as Prometheus text "
                         "on 127.0.0.1:PORT while the run is live "
                         "(stdlib HTTP; 0 picks an ephemeral port)")
    ap.add_argument("--devices", type=int, default=4,
                    help="logical slots in the shared pool")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-samples", type=int, default=1 << 10)
    ap.add_argument("--d-partitions", type=int, default=16)
    ap.add_argument("--resched-every", type=int, default=3)
    ap.add_argument("--max-rounds", type=int, default=500)
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)
    try:
        if args.workload:
            specs = parse_workload(args.workload, devices=args.devices,
                                   batch=args.batch, seq=args.seq,
                                   n_samples=args.n_samples,
                                   d_partitions=args.d_partitions)
        else:
            specs = parse_jobs(args.jobs, batch=args.batch, seq=args.seq,
                               n_samples=args.n_samples,
                               d_partitions=args.d_partitions)
    except ValueError as e:
        ap.error(str(e))

    from repro_torch.cluster import ClusterExecutor, make_policy
    from repro_torch.devices import slot_devices
    from repro_torch.sched.throughput import AnalyticModel, MeasuredModel

    pool = slot_devices(args.devices, args.device)
    policy_kw = {}
    if args.quanta and args.policy in ("tiresias", "elastic-tiresias"):
        policy_kw["quanta"] = tuple(
            float(q) for q in args.quanta.split(","))
    policy = make_policy(args.policy, **policy_kw)
    if any(getattr(s, "tier", "training") == "serving" for s in specs):
        # reclaim priority for the serving tier regardless of the base
        # policy; a no-op wrapper around already-serving-aware policies
        from repro_torch.sched.serving import CrossTierPolicy
        policy = CrossTierPolicy(policy)
    model = (MeasuredModel() if args.throughput_model == "measured"
             else AnalyticModel())
    faults = None
    if args.faults:
        from repro_torch.chaos import FaultPlan
        faults = FaultPlan.parse(args.faults)
    obs = None
    if args.trace_out or args.metrics_out or args.prom_port is not None:
        from repro_torch.obs import Observability
        obs = Observability(telemetry_out=args.metrics_out,
                            trace_out=args.trace_out,
                            prom_port=args.prom_port)
        if obs.prom_port is not None and not args.json:
            print(f"metrics: http://127.0.0.1:{obs.prom_port}/metrics",
                  file=sys.stderr)
    t0 = time.monotonic()
    ex = ClusterExecutor(specs, policy, devices=pool,
                         resched_every=args.resched_every,
                         throughput_model=model,
                         profile_sweeps=args.profile_sweeps,
                         profile_ttl=args.profile_ttl,
                         prefetch_shapes=args.prefetch_shapes,
                         compile_workers=args.compile_workers,
                         serialize_prep=args.serialize_prep or None,
                         compile_cache=args.compile_cache,
                         faults=faults, obs=obs)
    try:
        stats = ex.run(max_rounds=args.max_rounds)
    finally:
        ex.close()  # drop parked-job checkpoint state (unreachable now)
        if obs is not None:
            obs.close()     # flush telemetry + export the trace
    stats["wall_s"] = round(time.monotonic() - t0, 2)
    if obs is not None and not args.json:
        if args.trace_out:
            print(f"trace written to {args.trace_out} "
                  f"(open in chrome://tracing or ui.perfetto.dev)",
                  file=sys.stderr)
        if args.metrics_out:
            print(f"telemetry written to {args.metrics_out} "
                  f"({obs.bus.emitted} event(s))", file=sys.stderr)

    if args.json:
        print(json.dumps(stats))
        return 0
    print(f"policy={args.policy} model={args.throughput_model} "
          f"devices={ex.n_gpus} "
          f"rounds={stats['rounds']} wall={stats['wall_s']}s")
    print(f"{'job':>8s} {'profile':>10s} {'req_p':>5s} {'mp':>3s} "
          f"{'steps':>5s} {'jct':>7s} {'loss':>8s}")
    for j in stats["jobs"]:
        jct = f"{j['jct']:.0f}" if j["jct"] is not None else "-"
        loss = (f"{j['final_loss']:.3f}" if j["final_loss"] is not None
                else "-")
        print(f"{j['name']:>8s} {j['profile']:>10s} "
              f"{j['requested_p']:>5d} {j['model_parallel']:>3d} "
              f"{j['steps_done']:>5d} {jct:>7s} {loss:>8s}")
    print("events:")
    for e in stats["events"]:
        loan = f" (loan {e['loaned']})" if e["loaned"] else ""
        if e["op"] == "reshape":
            shape = (f"({e['from_p']}, mp={e['from_mp']}) -> "
                     f"({e['to_p']}, mp={e['to_mp']})")
            print(f"  round {e['round']:3d}  {e['op']:>9s}  "
                  f"{e['job']:>8s}  {shape}")
            continue
        mp = f" x{e['mp']}dev" if e.get("mp", 1) != 1 else ""
        print(f"  round {e['round']:3d}  {e['op']:>9s}  "
              f"{e['job'] or '-':>8s}  "
              f"p {e['from_p']} -> {e['to_p']}{mp}{loan}")
    print(f"device conservation: {'OK' if stats['conserved'] else 'LEAK'}; "
          f"max transient loan: {stats['max_loaned']} device(s); "
          f"preemptions: {stats['preemptions']} "
          f"(re-admitted {stats['readmissions']}); "
          f"reshapes: {stats['reshapes']}; "
          f"profile sweeps: {stats['profile_sweeps']}")
    if args.faults:
        lat = stats["mean_recovery_latency_s"]
        print(f"faults: {stats['workers_killed']} worker(s) killed, "
              f"{stats['devices_revoked']} device(s) revoked, pool "
              f"{stats['n_gpus_initial']} -> {stats['n_gpus']}; "
              f"{stats['recoveries']} recoveries"
              + (f" (mean latency {lat}s)" if lat is not None else ""))
    if "slo_attainment" in stats:
        att = stats["slo_attainment"]
        print(f"serving: {stats['rounds_served']} round(s) served, "
              f"{stats['slo_breaches']} SLO breach(es), p99 attainment "
              + (f"{att:.1%}" if att is not None else "-"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
