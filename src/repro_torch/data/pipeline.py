"""Synthetic token pipeline — deterministic, shardable, restart-safe.

A real deployment would stream tokenized shards; here the substrate generates
reproducible synthetic batches keyed by (seed, step) so that (a) a restarted
job resumes on exactly the data it would have seen (checkpoint stores only
the step), and (b) every data-parallel shard draws a disjoint stream.

Counterpart of the reference's ``data/pipeline.py``: ``__call__`` and
``batch_shape`` are its host numpy code, so both packages draw the same
tokens.  :meth:`SyntheticTokens.jit_batch` is the device-side batch (the
reference's in-graph threefry variant), drawn by a ``torch.Generator``
on the device; nothing on the training path calls it, in either package.
:func:`make_batch_specs` gives the dry run one global batch's shapes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SyntheticTokens", "make_batch_specs"]


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

    def jit_batch(self, step: int, device=None) -> dict:
        """Device-side batch for ``step``: the reference's in-graph variant,
        with its shapes, dtypes (int32 tokens, float32 vision embeds) and
        ranges, drawn on ``device`` (the card unless ``"cpu"``).

        A ``torch.Generator`` on the device is seeded from ``(seed, step)``,
        so the same pair gives the same batch on the same device and other
        steps differ.  The bits are torch's (Philox on the card), not
        threefry's: the batch equals neither the reference's ``jit_batch``
        nor :meth:`__call__`'s host draw.
        """
        import torch

        from ..device import resolve_device
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(((int(self.seed) << 20) ^ int(step)) % (1 << 63))
        batch = {"tokens": torch.randint(
            0, self.vocab_size, self.batch_shape(), generator=gen,
            device=dev, dtype=torch.int32)}
        if self.vision_tokens:
            batch["vision_embeds"] = torch.randn(
                (self.global_batch, self.vision_tokens, self.d_model),
                generator=gen, device=dev, dtype=torch.float32)
        return batch


def make_batch_specs(cfg, shape) -> dict:
    """Empty tensors of one global batch — the dry run's ``input_specs``;
    called under ``FakeTensorMode`` they allocate nothing.  Tokens are
    int64 (what the port's steps take), vision embeddings bf16 (the
    reference's spec)."""
    import torch
    B, L = shape.global_batch, shape.seq_len
    dims = (B, L, cfg.n_codebooks) if cfg.n_codebooks else (B, L)
    batch = {"tokens": torch.empty(dims, dtype=torch.long)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.empty(
            (B, cfg.vision_tokens, cfg.d_model), dtype=torch.bfloat16)
    return batch
