"""Filesystem helpers shared by the CDI writer, checkpoint, and state stores
(the port's copy of the reference module)."""

from __future__ import annotations

import json
import os
import tempfile


def atomic_write_json(path: str, obj: dict, indent: int | None = 2) -> None:
    """Write JSON via tempfile + rename so readers never see a torn file
    (the property kubelet's checkpoint store provides in the reference)."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=indent, sort_keys=True)
            f.write("\n")
            f.flush()
            # Durability, not just atomicity: without the fsync a power loss
            # after rename can surface an empty/truncated checkpoint, which
            # read() treats as corruption and wedges the plugin.
            os.fsync(f.fileno())
        os.rename(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    # Best-effort directory fsync: the rename is already committed, so a
    # failure here (fd exhaustion, EIO) must not make callers treat a
    # successful write as failed and roll back real state.
    try:
        dirfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
    except OSError:
        pass
