"""Fault-tolerant checkpointing: atomic, versioned, resumable.

Counterpart of the reference's ``checkpoint/manager.py``, with its layout:

* **atomicity** — write to ``step_XXXXXXXX.tmp`` then ``os.rename``
  (POSIX-atomic) so a crash mid-save never corrupts the latest checkpoint;
* **versioning + GC** — keep the last ``keep`` checkpoints, and remove
  orphaned ``.tmp`` directories of crashed saves;
* **resume** — ``restore_latest`` returns (step, tree) or (None, None); the
  training loop is written so restart reproduces the exact trajectory (the
  data pipeline is keyed by step);
* **per-process files** — each process saves ``proc_{rank}.npz`` (its
  ``torch.distributed`` rank, 0 without a process group) and
  ``manifest.json`` holds the step, the leaves' paths and their dtypes.

A tree is nested dicts and NamedTuples (the optimizer's
:class:`~repro_torch.optim.AdamWState`) whose leaves are tensors — e.g.
``{"params": model.state_dict(), "opt": opt_state}``.  numpy has no
bfloat16: a bfloat16 tensor is stored as its raw 16 bits (``uint16``) with
``bfloat16`` in the manifest, so that a round trip is bit-exact.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["CheckpointManager"]


def _children(node):
    """``(keys, children)`` of an inner node, or ``None`` for a leaf."""
    if isinstance(node, dict):
        return list(node), list(node.values())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(node._fields), list(node)
    return None


def _flatten_with_paths(tree, prefix: str = ""):
    kids = _children(tree)
    if kids is None:
        return [prefix], [tree]
    paths, leaves = [], []
    for key, child in zip(*kids):
        p, lv = _flatten_with_paths(child, f"{prefix}/{key}" if prefix
                                    else str(key))
        paths += p
        leaves += lv
    return paths, leaves


def _unflatten(like, leaves):
    """A tree shaped like ``like`` holding the leaves of the iterator
    ``leaves``, in flattening order."""
    kids = _children(like)
    if kids is None:
        return next(leaves)
    keys, children = kids
    vals = [_unflatten(c, leaves) for c in children]
    if isinstance(like, dict):
        return dict(zip(keys, vals))
    return type(like)(*vals)


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """``(array to store, dtype name for the manifest)``."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str,
                like: torch.Tensor) -> torch.Tensor:
    """The stored array as a tensor of ``like``'s dtype on its device."""
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree) -> str:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        paths, leaves = _flatten_with_paths(tree)
        stored = [_to_numpy(leaf) for leaf in leaves]
        np.savez(os.path.join(tmp, f"proc_{_rank()}.npz"),
                 **{f"leaf_{i}": arr for i, (arr, _) in enumerate(stored)})
        meta = {"step": step, "paths": paths,
                "dtypes": [dt for _, dt in stored]}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):                  # idempotent re-save
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        self._gc()
        return final

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        steps = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.isdir(os.path.join(self.dir, d)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def restore(self, step: int, like):
        """The tree saved at ``step``, shaped like ``like``: each leaf with
        the dtype and device of ``like``'s leaf at the same path.  ``like``
        itself is left alone."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        like_paths, like_leaves = _flatten_with_paths(like)
        if like_paths != meta["paths"]:
            raise ValueError("checkpoint/model structure mismatch: "
                             f"{len(meta['paths'])} vs {len(like_paths)} "
                             "leaves, or their paths differ")
        with np.load(os.path.join(path, f"proc_{_rank()}.npz")) as data:
            leaves = [_from_numpy(data[f"leaf_{i}"], dt, like_leaves[i])
                      for i, dt in enumerate(meta["dtypes"])]
        return _unflatten(like, iter(leaves))

    def restore_latest(self, like):
        steps = self.all_steps()
        if not steps:
            return None, None
        step = steps[-1]
        return step, self.restore(step, like)

    # -------------------------------------------------------------------- gc
    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
        # clean any orphaned tmp dirs from crashed saves
        for d in os.listdir(self.dir):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
