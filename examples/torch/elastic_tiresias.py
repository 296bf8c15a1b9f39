"""Elastic-Tiresias scheduling demo on the port's scheduler (paper §5.1,
§6.3): simulate a multi-tenant cluster on a Philly-like trace and compare
the JCT statistics of Tiresias (stop-resume costs) and Elastic-Tiresias
(EDL costs), through ``repro_torch.sched``. The simulator runs on the
host; no card is needed.

  PYTHONPATH=src python examples/torch/elastic_tiresias.py [--jobs 300] \\
      [--gpus 64]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=300)
    ap.add_argument("--gpus", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    from repro_torch.sched.simulator import ClusterSimulator, ScalingCosts
    from repro_torch.sched.tiresias import ElasticTiresias, Tiresias
    from repro_torch.sched.workload import philly_like

    base = ClusterSimulator(
        args.gpus, philly_like(n_jobs=args.jobs, seed=args.seed),
        Tiresias(), costs=ScalingCosts(mode="stop_resume")).run()
    elas = ClusterSimulator(
        args.gpus, philly_like(n_jobs=args.jobs, seed=args.seed),
        ElasticTiresias(), costs=ScalingCosts(mode="edl")).run()

    print(f"{'':16s} {'Tiresias':>14s} {'Elastic-Tiresias':>18s} "
          f"{'reduction':>10s}")
    for k, label in (("mean_jct", "Mean JCT (s)"),
                     ("median_jct", "Median JCT (s)"),
                     ("p95_jct", "95th pct (s)")):
        red = 1 - elas[k] / base[k]
        print(f"{label:16s} {base[k]:14.0f} {elas[k]:18.0f} {red:10.1%}")
    print(f"(paper, full Philly trace: mean -89.5%, median -48.1%, "
          f"p95 -95.4%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
