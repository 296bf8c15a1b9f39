"""Deterministic synthetic token corpus.

Sample ``i`` is a fixed function of (seed, i), so the exactly-once guarantee
of the dynamic pipeline is testable: the multiset of sample ids consumed in an
epoch must equal {0..n-1} under any scaling schedule.
"""
from __future__ import annotations

import numpy as np


class SyntheticTokenDataset:
    def __init__(self, n_samples: int, seq_len: int, vocab: int, *,
                 seed: int = 0, d_model: int = 0, embeds: bool = False):
        self.n_samples = n_samples
        self.seq_len = seq_len
        self.vocab = vocab
        self.seed = seed
        self.embeds = embeds
        self.d_model = d_model

    def read(self, start: int, count: int) -> dict:
        """Sequential read of samples [start, start+count) — the worker-side
        analogue of an HDFS ranged read of one partition chunk."""
        return self.read_ids(np.arange(start, start + count, dtype=np.int64))

    def read_ids(self, ids) -> dict:
        """Random-access read of an explicit sample-id array (a gather).
        The virtual-worker pipeline draws per-virtual-worker PERMUTED ids,
        so its reads are scattered rather than ranged; sample ``i`` is the
        same fixed function of (seed, i) on either path."""
        idx = np.asarray(ids, dtype=np.uint64)
        pos = np.arange(self.seq_len + 1, dtype=np.uint64)
        # splitmix-style hash of (seed, sample, position) -> token
        h = (idx[:, None] * np.uint64(0x9E3779B97F4A7C15)
             + pos[None, :] * np.uint64(0xBF58476D1CE4E5B9)
             + np.uint64(self.seed) * np.uint64(0x94D049BB133111EB))
        h ^= h >> np.uint64(31)
        h *= np.uint64(0xD6E8FEB86659FD93)
        h ^= h >> np.uint64(27)
        toks = (h % np.uint64(self.vocab)).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
               "sample_ids": idx.astype(np.int64)}
        if self.embeds:
            rng = np.random.default_rng(self.seed)
            proj = rng.standard_normal((self.vocab, self.d_model),
                                       dtype=np.float32) * 0.02
            out["embeds"] = proj[out.pop("tokens")]
        return out
