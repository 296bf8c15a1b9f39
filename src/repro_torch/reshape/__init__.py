"""Live reparallelization: the state-resharding subsystem (the RESHAPE
verb), ported from the reference's ``reshape`` package.

Describe the train state as a device-independent tensor collection
(``StateSpec``), plan the minimal slice/concat/all-gather moves between any
two ``(dp, mp)`` configurations (``plan_reshard``), and execute the plan in
memory at a mini-batch boundary (``apply_plan`` — the stop-free path
``ElasticTrainer.reshape`` commits) or through a checkpoint
(``core.stop_resume.resume_from_checkpoint`` — the fallback that lets a
job saved at one ``(dp, mp)`` restore at another). ``apply_plan_host`` is
the reference's numpy executor, the oracle of the tests.
"""
from repro_torch.reshape.spec import StateSpec, TensorLayout, flatten_tree, \
    unflatten_tree
from repro_torch.reshape.plan import ReshardPlan, TensorMove, plan_reshard
from repro_torch.reshape.apply import apply_plan, apply_plan_host, \
    assemble_state, gather_state, place_state, shard_state

__all__ = [
    "StateSpec", "TensorLayout", "flatten_tree", "unflatten_tree",
    "ReshardPlan", "TensorMove", "plan_reshard",
    "apply_plan", "apply_plan_host", "assemble_state", "shard_state",
    "place_state", "gather_state",
]
