"""Synthetic token pipeline — deterministic, shardable, restart-safe.

A real deployment would stream tokenized shards; here the substrate generates
reproducible synthetic batches keyed by (seed, step) so that (a) a restarted
job resumes on exactly the data it would have seen (checkpoint stores only
the step), and (b) every data-parallel shard draws a disjoint stream.

Counterpart of the reference's ``data/pipeline.py``: ``__call__`` and
``batch_shape`` are its host numpy code, so both packages draw the same
tokens.  Its in-graph variants (``jit_batch``, threefry, and
``make_batch_specs``, the dry run's shapes) belong to ROADMAP A14; nothing
on the training path calls them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SyntheticTokens"]


@dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_codebooks: int = 0
    vision_tokens: int = 0
    d_model: int = 0            # for vision embeds

    def batch_shape(self):
        if self.n_codebooks:
            return (self.global_batch, self.seq_len, self.n_codebooks)
        return (self.global_batch, self.seq_len)

    def __call__(self, step: int):
        """Global numpy batch for ``step`` (host-side; sharded by the caller)."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        batch = {"tokens": rng.integers(
            0, self.vocab_size, size=self.batch_shape(), dtype=np.int32)}
        if self.vision_tokens:
            batch["vision_embeds"] = rng.standard_normal(
                (self.global_batch, self.vision_tokens, self.d_model)
            ).astype(np.float32)
        return batch
