"""Small shared IO helpers (atomic artifact writes).

Both durable JSON artifacts in this repo — the benchmark summary the CI
regression gate reads and the serving policy's profile-state snapshot —
must never exist in a half-written form: a truncated JSON wedges the next
consumer harder than a missing one.  One writer, one semantics: serialize
to a temp file in the destination directory, then :func:`os.replace` into
place (atomic on POSIX), cleaning the temp file up on any failure.
"""
from __future__ import annotations

import json
import os
import tempfile

__all__ = ["write_json_atomic"]


def write_json_atomic(path: str, payload, *, indent: int | None = None) -> str:
    """Atomically write ``payload`` as JSON to ``path`` (temp + rename).

    A failed dump (non-serializable payload, full disk, crash) leaves any
    previous file at ``path`` intact and no ``*.tmp`` litter behind.
    """
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=indent)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path
