"""The token stream every cell trains on, handed to the trainer as its
``dataset``.

Sample ``i`` of a run is a fixed function of (seed, i): ``seq_len + 1``
tokens drawn uniformly from the vocabulary by a counter hash, so the rows
of a batch all differ and the reference can rebuild any row from its id
alone. The trainer's data iterators call ``read`` (a ranged read of one
partition's remainder) and the virtual-worker path ``read_ids``.
"""
from __future__ import annotations

import numpy as np

_M1 = np.uint64(0x9E3779B97F4A7C15)
_M2 = np.uint64(0xBF58476D1CE4E5B9)
_M3 = np.uint64(0x94D049BB133111EB)
_M4 = np.uint64(0xD6E8FEB86659FD93)


def tokens_of(ids, seq_len: int, vocab: int, seed: int) -> np.ndarray:
    """The ``[len(ids), seq_len + 1]`` int64 tokens of samples ``ids``."""
    idx = np.asarray(ids, dtype=np.uint64)
    pos = np.arange(seq_len + 1, dtype=np.uint64)
    key = np.uint64(int(seed) & 0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        h = idx[:, None] * _M1 + pos[None, :] * _M2 + (key ^ _M4) * _M3
        h ^= h >> np.uint64(31)
        h *= _M4
        h ^= h >> np.uint64(29)
        h *= _M2
        h ^= h >> np.uint64(32)
    return (h % np.uint64(vocab)).astype(np.int64)


class TokenStream:
    """``n_samples`` samples of ``seq_len`` tokens (and their labels, the
    next tokens) keyed by ``seed``."""

    def __init__(self, n_samples: int, seq_len: int, vocab: int, seed: int):
        self.n_samples = n_samples
        self.seq_len = seq_len
        self.vocab = vocab
        self.seed = seed

    def read(self, start: int, count: int) -> dict:
        return self.read_ids(np.arange(start, start + count, dtype=np.int64))

    def read_ids(self, ids) -> dict:
        ids = np.asarray(ids, dtype=np.int64)
        toks = tokens_of(ids, self.seq_len, self.vocab, self.seed)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32),
                "sample_ids": ids}
