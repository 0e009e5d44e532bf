"""Orphan cleanup: reclaim state left behind by crashed prepares.

The reference acknowledges this gap as TODOs (lengrongfu/k8s-dra-driver,
cmd/nvidia-dra-plugin/driver.go:154-166: "TODO: implement loop to remove CDI
files for claims that no longer exist", and the MPS equivalent). Here it is
implemented: a periodic pass removes

- transient CDI claim spec files whose claim is not in the checkpoint,
- process-share session dirs with no owning claim,
- sharing-state entries for claims the checkpoint no longer knows

and, when a kube client is available, unprepares checkpointed claims whose
ResourceClaim was deleted from the API server without kubelet calling
NodeUnprepareResources (node reboot races, force-deleted pods).

The port's copy of the reference module.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from ..kube.client import KubeClient
from ..kube.errors import NotFoundError
from ..kube.resourceapi import ResourceApi
from .device_state import DeviceState

logger = logging.getLogger(__name__)


class OrphanCleaner:
    def __init__(
        self,
        state: DeviceState,
        kube_client: Optional[KubeClient] = None,
        interval_seconds: float = 600.0,
        resource_api=None,
        on_dialect_change=None,
    ):
        """``resource_api`` may be a ResourceApi or a zero-arg callable
        returning one (the Driver passes ``lambda: self.resource_api`` so
        the cleaner always sees the LIVE negotiated dialect — a stale
        captured GVR plus a wrong-dialect 404 would read as "claim
        deleted" and mass-unprepare running pods). ``on_dialect_change``
        is invoked with the re-discovered ResourceApi when the cleaner
        detects the served dialect moved."""
        self.state = state
        self.kube_client = kube_client
        if resource_api is None:
            resource_api = ResourceApi.discover(kube_client)
        self._api_source = (
            resource_api if callable(resource_api) else (lambda: resource_api)
        )
        self.on_dialect_change = on_dialect_change
        self.interval = interval_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.passes = 0
        self.removed_cdi = 0
        self.removed_share_dirs = 0
        self.removed_share_claims = 0
        self.unprepared_deleted = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="orphan-cleaner"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(timeout=self.interval):
            try:
                self.clean_once()
            except Exception:
                logger.exception("orphan cleanup pass failed")

    # -- one pass ----------------------------------------------------------

    def clean_once(self) -> None:
        self.passes += 1
        # File cleanup runs under the DeviceState lock so a prepare that
        # lands between "read checkpoint" and "list files" cannot have its
        # fresh CDI spec / share dir misclassified as orphaned.
        with self.state._lock:
            prepared = self.state.checkpoint.read()
            self._clean_cdi_files(prepared)
            self._clean_share_dirs(prepared)
            self._clean_share_state(prepared)
        if self.kube_client is not None:
            # Outside the lock: unprepare() takes it itself, and re-checks
            # the checkpoint, so a stale snapshot here is harmless.
            self._unprepare_deleted_claims(prepared)

    def _clean_cdi_files(self, prepared: dict) -> None:
        for uid in self.state.cdi.list_claim_spec_uids():
            if uid not in prepared:
                logger.info("removing orphaned CDI spec for claim %s", uid)
                self.state.cdi.delete_claim_spec_file(uid)
                self.removed_cdi += 1

    def _clean_share_dirs(self, prepared: dict) -> None:
        run_dir = self.state.ps_manager.run_dir
        try:
            entries = os.listdir(run_dir)
        except FileNotFoundError:
            return
        for entry in entries:
            # Session dirs are "<claim_uid>-<5 hex digest>" (sharing.py).
            claim_uid = entry.rsplit("-", 1)[0]
            if claim_uid not in prepared:
                logger.info("removing orphaned share dir %s", entry)
                import shutil

                shutil.rmtree(os.path.join(run_dir, entry), ignore_errors=True)
                self.removed_share_dirs += 1

    def _clean_share_state(self, prepared: dict) -> None:
        """Release share-state claim entries the checkpoint no longer knows.

        A crash between SharingStateStore.acquire and checkpoint.write leaves
        phantom claim entries that pin chips in a sharing mode; unprepare is a
        no-op for claims not in the checkpoint, so without this pass later
        claims would fail with ModeConflictError forever.
        """
        from ..tpulib.chiplib import SHARING_EXCLUSIVE
        from .sharing import CorruptShareStateError

        store = self.state.share_state
        try:
            entries = os.listdir(store.state_dir)
        except FileNotFoundError:
            return
        freed: list[str] = []
        for entry in entries:
            if not entry.endswith(".share.json"):
                continue
            uuid = entry[: -len(".share.json")]
            try:
                st = store.get(uuid)
            except CorruptShareStateError:
                logger.exception("share state for chip %s unreadable; skipping", uuid)
                continue
            for claim_uid in [c for c in st.claims if c not in prepared]:
                logger.info(
                    "releasing phantom share-state entry: claim %s on chip %s",
                    claim_uid, uuid,
                )
                if store.release(uuid, claim_uid):
                    freed.append(uuid)
                self.removed_share_claims += 1
        if freed:
            self.state.chiplib.set_sharing_mode(freed, SHARING_EXCLUSIVE)

    def _unprepare_deleted_claims(self, prepared: dict) -> None:
        from .prepared import PreparedClaim

        api = self._api_source()
        dialect_checked = False
        for uid, rec in list(prepared.items()):
            pc = PreparedClaim.from_dict(rec)
            if not pc.namespace or not pc.name:
                continue
            try:
                obj = self.kube_client.get(
                    api.claims, pc.name, namespace=pc.namespace
                )
                if obj["metadata"].get("uid", "") == uid:
                    continue  # still live
            except NotFoundError:
                # A 404 is ambiguous: the claim is gone — or the server
                # stopped serving OUR dialect and EVERY claim would 404,
                # which must not read as "unprepare everything". Verify
                # the dialect once per pass before trusting any 404.
                if not dialect_checked:
                    dialect_checked = True
                    current = ResourceApi.try_discover(self.kube_client)
                    if current is not None and current.version != api.version:
                        logger.warning(
                            "served resource.k8s.io dialect is %s but the "
                            "cleaner was using %s; aborting this cleanup "
                            "pass", current.version, api.version,
                        )
                        if self.on_dialect_change is not None:
                            self.on_dialect_change(current)
                        return
            except Exception:
                logger.exception(
                    "could not verify claim %s/%s; skipping", pc.namespace, pc.name
                )
                continue
            logger.info(
                "unpreparing claim %s (%s/%s): deleted from API server",
                uid, pc.namespace, pc.name,
            )
            self.state.unprepare(uid)
            self.unprepared_deleted += 1
