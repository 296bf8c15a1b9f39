"""The device-free half of the reference's reshape package: the
``StateSpec`` description of a train state's layout, which checkpoints
carry. The reshard planner and its live executor (``plan.py``,
``apply.py``) come with model parallelism."""
from repro_torch.reshape.spec import StateSpec, TensorLayout, flatten_tree, \
    unflatten_tree

__all__ = ["StateSpec", "TensorLayout", "flatten_tree", "unflatten_tree"]
