"""The reference's random bits, bit for bit: JAX's default PRNG, threefry2x32
with partitionable counters, on torch tensors.

A key is a tensor of two 32-bit words ``[k0, k1]``, held as int64 on the
device that uses it, so that a key made from a device tensor (the train
state's ``step``) costs no host sync. Every word is an int64 masked to
32 bits, since torch's uint32 lacks some of the operators used here; the
arithmetic is integer, so the bits are the same on every device.

  * ``key(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]``
    (``jax.random.PRNGKey``);
  * ``fold_in(key, d)``: ``threefry2x32(key, (0, d))``;
  * ``random_bits(key, shape)``: the flat index i of each element gives the
    counters ``(i >> 32, i & 0xFFFFFFFF)``, and the element is the xor of
    the two output words;
  * ``uniform(key, shape)``: the float32 in [0, 1) whose mantissa is the
    top 23 bits;
  * ``bernoulli(key, p, shape)``: ``uniform < p`` in float32.

No Pallas kernel stands behind ``jax.random``; these are plain torch ops.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words ``x0``, ``x1`` (int64
    tensors of one shape, each < 2**32) under the key ``k``, as
    ``jax._src.prng._threefry2x32_lowering`` computes it."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``."""
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(k, data)``; ``data`` an int or a 0-d integer
    tensor (the train state's ``step``), taken as uint32."""
    d = torch.as_tensor(data, device=k.device).to(torch.int64) & MASK
    x0, x1 = threefry2x32(k, torch.zeros_like(d), d)
    return torch.stack([x0, x1])


def random_bits(k: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32) as int64 words."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device)
    x0, x1 = threefry2x32(k, i >> 32, i & MASK)
    return (x0 ^ x1).reshape(shape)


def uniform(k: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.uniform(k, shape)``: float32 in [0, 1)."""
    bits = (random_bits(k, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(k: torch.Tensor, p: float, shape: tuple) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` for a float ``p``: a bool mask,
    True where ``uniform < p`` in float32."""
    return uniform(k, shape) < torch.tensor(p, dtype=torch.float32,
                                            device=k.device)
