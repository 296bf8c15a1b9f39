"""End-to-end elastic training on the PyTorch port (the paper's core
demonstration): the ``edl-paper`` decoder trains while a scaling schedule
exercises a stop-free scale-out, a graceful scale-in and a fused migration,
then the scaling records and the exactly-once accounting are printed.

Full-size run on the card (the ~160M-parameter model, a few hundred steps):

  PYTHONPATH=src python examples/torch/elastic_training.py

CPU demo (the SMOKE model, the same code paths):

  PYTHONPATH=src python examples/torch/elastic_training.py --demo \\
      --device cpu

Other arguments pass through to ``python -m repro_torch.launch.train``.
"""
import subprocess
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    demo = "--demo" in argv
    passthrough = [a for a in argv if a != "--demo"]
    args = [sys.executable, "-m", "repro_torch.launch.train",
            "--arch", "edl-paper", "--devices", "8", "--init-p", "2",
            "--schedule", "out:2@40,in:1@120,migrate:1@160"]
    if demo:
        args += ["--smoke", "--steps", "200", "--batch", "8", "--seq", "64"]
    else:
        args += ["--steps", "300", "--batch", "8", "--seq", "256"]
    args += passthrough
    return subprocess.call(args)


if __name__ == "__main__":
    sys.exit(main())
