"""Checksummed, versioned checkpoint store for prepared claims.

Role of the reference's checkpoint (lengrongfu/k8s-dra-driver,
cmd/nvidia-dra-plugin/checkpoint.go:9-53 + the vendored kubelet
checkpointmanager): a single JSON file under the plugin registration dir
holding every prepared claim, so Prepare is idempotent across kubelet retries
and plugin restarts (device_state.go:134-156).

Differences from the reference: writes are atomic (tempfile + rename — the
kubelet manager does the same via its store), and corrupt checkpoints raise
``CorruptCheckpointError`` instead of silently resetting, so operators see
the condition. (The port's copy of the reference module.)
"""

from __future__ import annotations

import hashlib
import json
import os

from ..utils.fs import atomic_write_json
from ..utils.tracing import child_span

CHECKPOINT_VERSION = "v1"


class CorruptCheckpointError(RuntimeError):
    pass


def _checksum(payload: dict) -> str:
    """Stable digest over the payload with the checksum field zeroed
    (compute-then-verify pattern, checkpoint.go:28-53)."""
    clone = dict(payload)
    clone["checksum"] = ""
    blob = json.dumps(clone, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


class CheckpointManager:
    """File-backed store of {claim_uid: prepared-claim JSON}."""

    def __init__(self, path: str):
        self.path = path

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def create_if_missing(self) -> None:
        """device_state.go:109-125 analog: start from an empty map."""
        if not self.exists():
            self.write({})

    def read(self) -> dict[str, dict]:
        """Read and verify the prepared-claims map.

        Every way a checkpoint file can be bad surfaces as
        ``CorruptCheckpointError``: truncated/garbage JSON
        (JSONDecodeError), a non-object or field-less payload (KeyError/
        TypeError/AttributeError), and checksum/version mismatches. A
        missing file stays FileNotFoundError — that is "never created",
        not corruption, and callers treat the two differently. Other
        OSErrors (EIO from a dying disk) wrap too: to the recovery path
        (quarantine + restart from empty) an unreadable checkpoint and an
        undecodable one are the same condition.
        """
        from ..utils import faults

        faults.fire("checkpoint.read")
        try:
            with open(self.path) as f:
                payload = json.load(f)
        except FileNotFoundError:
            raise
        except (OSError, ValueError) as e:
            raise CorruptCheckpointError(
                f"checkpoint {self.path}: unreadable: {e}"
            ) from e
        if not isinstance(payload, dict):
            raise CorruptCheckpointError(
                f"checkpoint {self.path}: payload is "
                f"{type(payload).__name__}, not an object"
            )
        want = payload.get("checksum", "")
        if _checksum(payload) != want:
            raise CorruptCheckpointError(
                f"checkpoint {self.path}: checksum mismatch"
            )
        if payload.get("version") != CHECKPOINT_VERSION:
            raise CorruptCheckpointError(
                f"checkpoint {self.path}: unknown version {payload.get('version')!r}"
            )
        claims = payload.get("preparedClaims")
        if not isinstance(claims, dict):
            raise CorruptCheckpointError(
                f"checkpoint {self.path}: preparedClaims missing or not a map"
            )
        return claims

    def write(self, prepared_claims: dict[str, dict]) -> None:
        from ..utils import faults

        faults.fire("checkpoint.write")
        with child_span("checkpoint-write") as sp:
            sp.set_tag("claims", len(prepared_claims))
            payload = {
                "version": CHECKPOINT_VERSION,
                "preparedClaims": prepared_claims,
                "checksum": "",
            }
            payload["checksum"] = _checksum(payload)
            atomic_write_json(self.path, payload, indent=1)

    def quarantine(self) -> str:
        """Move a corrupt checkpoint aside to ``<path>.corrupt`` (clobbering
        any older quarantine — the freshest evidence wins) and return the
        quarantine path. The startup recovery seam: a DaemonSet pod must
        not crash-loop on a checkpoint no restart will ever fix; parking
        the file preserves it for forensics while the plugin continues
        from empty state (prepared claims re-prepare idempotently)."""
        quarantine_path = f"{self.path}.corrupt"
        os.replace(self.path, quarantine_path)
        return quarantine_path
