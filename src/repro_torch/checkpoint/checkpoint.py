"""Checkpointing: train state (params + optimizer moments + step) plus the
data-pipeline state, so a restored job resumes exactly-once data
consumption — EDL §4.3's requirement that the partition permutation list
and worker progress are checkpointed too.

The reference's format: ``state.npz`` with the ``/``-joined tree paths as
keys, plus a ``meta.json`` sidecar for pipeline/meta state, each written
to a temporary name and atomically replaced. A bfloat16 leaf is stored as
the reference stores it, as 2-byte void records (``V2``) holding its bits,
and read back by its bits, so a bf16 state round-trips bit-exact — from
this package's files and from the JAX package's alike. Every other dtype
is stored as itself.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.reshape.spec import flatten_tree, unflatten_tree

_BF16_RECORD = np.dtype("V2")


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RECORD)
    return t.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.require(a, requirements="C")     # keeps 0-d arrays 0-d
    if a.dtype == _BF16_RECORD:     # bf16 bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_checkpoint(path: str, state, *, step: int | None = None,
                    pipeline_state: dict | None = None,
                    extra: dict | None = None):
    os.makedirs(path, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in flatten_tree(state).items()}
    # atomic replace: a job stopped twice reuses its checkpoint dir, so a
    # save that dies mid-write must not tear the previous good state
    # (np.savez appends .npz to extension-less names — keep the suffix)
    tmp_npz = os.path.join(path, "state.tmp.npz")
    np.savez(tmp_npz, **flat)
    os.replace(tmp_npz, os.path.join(path, "state.npz"))
    meta = {"step": int(step if step is not None
                        else np.asarray(flat.get("step", 0))),
            "pipeline": pipeline_state, "extra": extra or {}}
    tmp = os.path.join(path, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(path, "meta.json"))


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """Returns (state tree of CPU tensors, meta). Leaves keep the dtype
    they were written with; bf16 records come back as bf16 tensors."""
    with np.load(os.path.join(path, "state.npz")) as z:
        flat = {k: _from_numpy(z[k]) for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return unflatten_tree(flat), meta
