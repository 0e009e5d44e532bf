"""Build/version identity for both binaries.

Role of the reference's internal/info/version.go:40 (version + gitCommit
injected via -ldflags, Makefile:60). Python has no link step; the commit is
baked in by the image build (deployments/container/Dockerfile writes
_build_info.py) or supplied via TPU_DRA_GIT_COMMIT, falling back to "dev".
"""

from __future__ import annotations

import os

VERSION = "0.2.0"


def git_commit() -> str:
    try:
        from . import _build_info  # type: ignore

        return _build_info.GIT_COMMIT
    except ImportError:
        return os.environ.get("TPU_DRA_GIT_COMMIT", "dev")


def version_string() -> str:
    """"<version>-<commit>" (GetVersionString analog, version.go:40)."""
    return f"{VERSION}-{git_commit()}"
