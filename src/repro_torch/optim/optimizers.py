"""Optimizers over nested dicts of tensors: SGD(+momentum), Adam, AdamW.

The reference's functional form and state: ``update(grads, state, params)``
returns new params and ``{"count", "mu"[, "nu"]}`` without touching its
inputs. Moments are fp32 regardless of param dtype; the bias correction is
computed in fp32 from the int32 count, as the reference does. Adam's leaf
update is ``kernels/optim/ops.py: adamw_update``: one kernel a leaf on the
card, with the eager formula's bits; the formula itself on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.kernels.optim.ops import adamw_update
from repro_torch.models.params import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], dict]
    update: Callable[[Any, dict, Any], tuple[Any, dict]]
    slots: int          # number of fp32 moment trees (for memory accounting)


def _zeros_f32(params) -> dict:
    return tree_unflatten((k, torch.zeros_like(p, dtype=torch.float32))
                          for k, p in tree_leaves(params))


def _count0(params) -> torch.Tensor:
    dev = tree_leaves(params)[0][1].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr: float = 0.1, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"count": _count0(params), "mu": _zeros_f32(params)}

    @torch.no_grad()
    def update(grads, state, params):
        g, m = dict(tree_leaves(grads)), dict(tree_leaves(state["mu"]))
        new_p, mu = [], []
        for k, p in tree_leaves(params):
            mk = momentum * m[k] + g[k].float()
            mu.append((k, mk))
            new_p.append((k, (p.float() - lr * mk).to(p.dtype)))
        return tree_unflatten(new_p), {"count": state["count"] + 1,
                                       "mu": tree_unflatten(mu)}

    return Optimizer("sgd", init, update, slots=1)


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"count": _count0(params), "mu": _zeros_f32(params),
                "nu": _zeros_f32(params)}

    @torch.no_grad()
    def update(grads, state, params):
        c = state["count"] + 1
        # the bases filled on the device (no copy from the host, no wait for
        # the stream), raised to the int32 count as fp32
        bc1 = 1.0 - torch.full((), b1, dtype=torch.float32, device=c.device) ** c
        bc2 = 1.0 - torch.full((), b2, dtype=torch.float32, device=c.device) ** c
        g = dict(tree_leaves(grads))
        mu0 = dict(tree_leaves(state["mu"]))
        nu0 = dict(tree_leaves(state["nu"]))
        new_p, mu, nu = [], [], []
        for k, p in tree_leaves(params):
            p1, m, v = adamw_update(p, g[k], mu0[k], nu0[k], bc1, bc2, lr=lr,
                                    b1=b1, b2=b2, eps=eps,
                                    weight_decay=weight_decay)
            new_p.append((k, p1))
            mu.append((k, m))
            nu.append((k, v))
        return tree_unflatten(new_p), {"count": c, "mu": tree_unflatten(mu),
                                       "nu": tree_unflatten(nu)}

    return Optimizer("adam" if not weight_decay else "adamw",
                     init, update, slots=2)


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay)


def init_opt_state(optimizer: Optimizer, params) -> dict:
    return optimizer.init(params)
