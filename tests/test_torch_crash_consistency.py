"""Crash consistency of the port's device layer: the plugin dies HARD
mid-prepare and recovers.

The twins of the reference's ``tests/test_crash_consistency.py`` on
``k8s_dra_driver_tpu_torch``, and the same two crash points on a MIG
device's prepare. Each scenario runs a REAL subprocess that os._exit()s
at an injected point inside prepare, then restarts DeviceState over the
same state dirs and drives recovery the way kubelet would. State lives
under a short ``tempfile.mkdtemp`` directory, as the plugin's gRPC
sockets must (a unix socket path stays under 106 bytes).

Crash points covered:
- after the sharing-state acquire, before the checkpoint write -> the
  orphan cleaner must release the phantom hold;
- after the checkpoint write -> the retried prepare must return the
  cached result idempotently, and unprepare must fully clean up.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

DRIVER = "tpu.google.com"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# An H100 node whose GPU 0 is in MIG mode (the MIG case's node).
MIG_LAYOUT = {0: [("3g.40gb", 0), ("2g.20gb", 4), ("1g.10gb", 6)]}
MIG_DEVICE = "tpu-0-mig-14-4-2"

CRASH_SCRIPT = """
import os, sys
sys.path.insert(0, "@REPO@")
from k8s_dra_driver_tpu_torch.cdi import CDIHandler
from k8s_dra_driver_tpu_torch.plugin.checkpoint import CheckpointManager
from k8s_dra_driver_tpu_torch.plugin.device_state import DeviceState
from k8s_dra_driver_tpu_torch.tpulib import FakeChipLib

root = sys.argv[1]
crash_point = sys.argv[2]
node = sys.argv[3]


class CrashingLib(FakeChipLib):
    # Simulates SIGKILL: no exception, no rollback, no atexit.
    def set_sharing_mode(self, uuids, mode):
        super().set_sharing_mode(uuids, mode)
        if crash_point == "after-acquire" and mode != "exclusive":
            os._exit(9)


class CrashingCDI(CDIHandler):
    # An exclusive prepare sets no sharing mode: its hold is taken
    # before the claim spec is written, so the crash comes there.
    def create_claim_spec_file(self, *args, **kwargs):
        if crash_point == "after-acquire":
            os._exit(9)
        return super().create_claim_spec_file(*args, **kwargs)


if node == "mig":
    lib = CrashingLib(generation="h100", topology="2x1x1", mig=@MIG@)
    device, configs = "@DEVICE@", []
else:
    lib = CrashingLib(generation="v5p", topology="2x2x1")
    device, configs = "tpu-1", [{
        "source": "FromClaim", "requests": [],
        "opaque": {"driver": "tpu.google.com", "parameters": {
            "apiVersion": "tpu.google.com/v1alpha1",
            "kind": "TpuChipConfig",
            "sharing": {"strategy": "TimeShared"},
        }},
    }]

state = DeviceState(
    chiplib=lib,
    cdi=CrashingCDI(os.path.join(root, "cdi")),
    checkpoint=CheckpointManager(os.path.join(root, "checkpoint.json")),
    driver_name="tpu.google.com",
    pool_name="node-a",
    state_dir=os.path.join(root, "state"),
)
claim = {
    "metadata": {"name": "c", "namespace": "default", "uid": "uid-crash"},
    "status": {"allocation": {"devices": {"results": [
        {"request": "r", "driver": "tpu.google.com", "pool": "node-a",
         "device": device}
    ], "config": configs}}},
}
state.prepare(claim)
if crash_point == "after-checkpoint":
    os._exit(9)
"""


@pytest.fixture
def state_root():
    root = Path(tempfile.mkdtemp(prefix="crash-"))
    yield root
    shutil.rmtree(root, ignore_errors=True)


def run_crash(root: Path, crash_point: str, node: str = "v5p") -> int:
    script = root / "crash.py"
    script.write_text(CRASH_SCRIPT.replace("@REPO@", REPO_ROOT)
                      .replace("@MIG@", repr(MIG_LAYOUT))
                      .replace("@DEVICE@", MIG_DEVICE))
    proc = subprocess.run(
        [sys.executable, str(script), str(root), crash_point, node],
        capture_output=True,
        text=True,
        timeout=120,
    )
    return proc.returncode


def restart_state(root: Path, node: str = "v5p"):
    from k8s_dra_driver_tpu_torch.cdi import CDIHandler
    from k8s_dra_driver_tpu_torch.plugin.checkpoint import CheckpointManager
    from k8s_dra_driver_tpu_torch.plugin.device_state import DeviceState
    from k8s_dra_driver_tpu_torch.tpulib import FakeChipLib

    lib = (FakeChipLib(generation="h100", topology="2x1x1", mig=MIG_LAYOUT)
           if node == "mig" else
           FakeChipLib(generation="v5p", topology="2x2x1"))
    return DeviceState(
        chiplib=lib,
        cdi=CDIHandler(str(root / "cdi")),
        checkpoint=CheckpointManager(str(root / "checkpoint.json")),
        driver_name=DRIVER,
        pool_name="node-a",
        state_dir=str(root / "state"),
    )


def make_claim(uid="uid-crash", device="tpu-1"):
    return {
        "metadata": {"name": "c", "namespace": "default", "uid": uid},
        "status": {"allocation": {"devices": {"results": [
            {"request": "r", "driver": DRIVER, "pool": "node-a",
             "device": device}
        ], "config": []}}},
    }


class TestCrashMidPrepare:
    def test_crash_after_acquire_cleaner_releases_phantom(self, state_root):
        assert run_crash(state_root, "after-acquire") == 9
        state = restart_state(state_root)
        # Nothing checkpointed — the claim never finished preparing.
        assert state.checkpoint.read() == {}
        # The phantom TimeShared hold survived the crash on disk: a new
        # EXCLUSIVE claim on the same chip must be refused until cleanup.
        from k8s_dra_driver_tpu_torch.plugin.sharing import SharingError

        try:
            state.prepare(make_claim(uid="uid-new"))
            held = False
        except SharingError:
            held = True
        assert held, "phantom sharing hold vanished without the cleaner"

        from k8s_dra_driver_tpu_torch.plugin.cleanup import OrphanCleaner

        OrphanCleaner(state, kube_client=None, interval_seconds=0).clean_once()
        # Cleaned: the chip is allocatable again.
        devices = state.prepare(make_claim(uid="uid-new"))
        assert devices[0].device_name == "tpu-1"
        state.unprepare("uid-new")
        assert state.checkpoint.read() == {}

    def test_crash_after_checkpoint_retry_is_idempotent(self, state_root):
        assert run_crash(state_root, "after-checkpoint") == 9
        state = restart_state(state_root)
        # The claim IS checkpointed; kubelet retries the RPC after the
        # restart and must get the recorded result, not a re-prepare.
        ckpt = state.checkpoint.read()
        assert list(ckpt) == ["uid-crash"]
        devices = state.prepare(make_claim())
        assert devices[0].device_name == "tpu-1"
        # The claim CDI spec written before the crash is intact JSON.
        spec_path = (
            state_root / "cdi" / "k8s.tpu.google.com-claim_uid-crash.json"
        )
        json.loads(spec_path.read_text())
        # Full teardown leaves no residue.
        state.unprepare("uid-crash")
        assert state.checkpoint.read() == {}
        assert not spec_path.exists()


class TestCrashMidMigPrepare:
    def test_crash_after_acquire_cleaner_releases_phantom(self, state_root):
        """The MIG device's exclusive hold (keyed by its MIG uuid) was
        written and nothing else: the next claim on it is refused until
        the orphan cleaner releases the hold."""
        assert run_crash(state_root, "after-acquire", "mig") == 9
        state = restart_state(state_root, "mig")
        assert state.checkpoint.read() == {}
        mig_uuid = state.allocatable[MIG_DEVICE].tensorcore.uuid
        assert state.share_state.list_chips() == [mig_uuid]
        from k8s_dra_driver_tpu_torch.plugin.sharing import SharingError

        with pytest.raises(SharingError):
            state.prepare(make_claim(uid="uid-new", device=MIG_DEVICE))
        from k8s_dra_driver_tpu_torch.plugin.cleanup import OrphanCleaner

        OrphanCleaner(state, kube_client=None, interval_seconds=0).clean_once()
        devices = state.prepare(make_claim(uid="uid-new", device=MIG_DEVICE))
        assert devices[0].device_name == MIG_DEVICE
        state.unprepare("uid-new")
        assert state.checkpoint.read() == {}
        assert state.share_state.list_chips() == []

    def test_crash_after_checkpoint_retry_is_idempotent(self, state_root):
        assert run_crash(state_root, "after-checkpoint", "mig") == 9
        state = restart_state(state_root, "mig")
        assert list(state.checkpoint.read()) == ["uid-crash"]
        devices = state.prepare(make_claim(device=MIG_DEVICE))
        assert devices[0].device_name == MIG_DEVICE
        spec_path = (
            state_root / "cdi" / "k8s.tpu.google.com-claim_uid-crash.json"
        )
        spec = json.loads(spec_path.read_text())
        env = dict(e.split("=", 1) for e in spec["containerEdits"]["env"])
        assert env["CUDA_VISIBLE_DEVICES"] == \
            state.allocatable[MIG_DEVICE].tensorcore.uuid
        state.unprepare("uid-crash")
        assert state.checkpoint.read() == {}
        assert not spec_path.exists()
        assert state.share_state.list_chips() == []
