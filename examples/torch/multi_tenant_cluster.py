"""Multi-tenant elastic cluster demo on the PyTorch port (paper §6): three
tenants share one pool of slots; the scheduling policy retunes their
parallelism live. A scale-in of an over-provisioned job funds a scale-out
(a transient loan) of a better-scaling one, a late arrival reclaims the
loan, and every slot move is a real stop-free ``ElasticTrainer`` switch.
Policies may also give a running tenant 0 slots: the executor
checkpoint-stops it to disk and re-admits it once capacity frees up.

  PYTHONPATH=src python examples/torch/multi_tenant_cluster.py
  PYTHONPATH=src python examples/torch/multi_tenant_cluster.py \\
      --device cpu --devices 4 \\
      --jobs "a=vgg19:2:16@0,b=resnet50:1:16@0,c=googlenet:1:10@4"
  # preemptive time-sharing under plain Tiresias
  PYTHONPATH=src python examples/torch/multi_tenant_cluster.py \\
      --policy tiresias --quanta 0.1,1000 \\
      --jobs "a=resnet50:2:20@0,b=vgg19:4:12@6"
  # the kernel libraries built once into a persistent cache
  PYTHONPATH=src python examples/torch/multi_tenant_cluster.py \\
      --compile-cache ~/.cache/repro_torch_kernels

The slots live on the card by default (several on one card when there is
one), on the CPU with --device cpu. Every flag is
``python -m repro_torch.launch.cluster``'s; the job grammar is
``name=profile:requested_p:total_steps[:mp=M|mp=auto]@arrival_round``.
"""
import sys

from repro_torch.launch.cluster import main

if __name__ == "__main__":
    sys.exit(main())
