"""The port's device layer against the reference's: the opaque-config
API, CDI specs and ``DeviceState`` Prepare/Unprepare.

On a TPU fake both packages run the same documents and the same scripted
claim sequence in their own temporary directories, and every observable
must be equal: decoded configs and errors, CDI files byte for byte,
kubelet devices, the checkpoint, the sharing state and
``published_resources()``. On a fake node of 8 H100s the runtime
mapping of ``cdi/runtime.py`` is checked.
"""

from __future__ import annotations

import json
import os

import pytest

from k8s_dra_driver_tpu.api import v1alpha1 as ref_api
from k8s_dra_driver_tpu.cdi import CDIHandler as RefCDIHandler
from k8s_dra_driver_tpu.plugin.checkpoint import (
    CheckpointManager as RefCheckpointManager,
)
from k8s_dra_driver_tpu.plugin.device_state import DeviceState as RefDeviceState
from k8s_dra_driver_tpu.tpulib import FakeChipLib as RefFakeChipLib
from k8s_dra_driver_tpu_torch.api import v1alpha1 as api
from k8s_dra_driver_tpu_torch.cdi import CDIHandler
from k8s_dra_driver_tpu_torch.plugin import CheckpointManager, DeviceState
from k8s_dra_driver_tpu_torch.tpulib import FakeChipLib

DRIVER = "tpu.google.com"
API = "tpu.google.com/v1alpha1"


def chip_config(sharing=None):
    doc = {"apiVersion": API, "kind": "TpuChipConfig"}
    if sharing is not None:
        doc["sharing"] = sharing
    return doc


# Opaque documents: valid ones of every kind and strategy, and each way
# the reference refuses one.
DOCUMENTS = [
    chip_config(),
    chip_config({"strategy": "Exclusive"}),
    chip_config({"strategy": "TimeShared"}),
    chip_config({"strategy": "TimeShared",
                 "timeSharedConfig": {"interval": "Long"}}),
    chip_config({"strategy": "TimeShared",
                 "timeSharedConfig": {"interval": "Forever"}}),
    chip_config({"strategy": "ProcessShared"}),
    chip_config({"strategy": "ProcessShared", "processSharedConfig": {
        "maxProcesses": 4, "defaultHbmLimit": "8Gi",
        "defaultActiveCorePercentage": 50,
        "perChipHbmLimit": {"0": "2Gi"}}}),
    chip_config({"strategy": "ProcessShared", "processSharedConfig": {
        "maxProcesses": 0}}),
    chip_config({"strategy": "ProcessShared", "processSharedConfig": {
        "defaultActiveCorePercentage": 101}}),
    chip_config({"strategy": "ProcessShared", "processSharedConfig": {
        "maxProcesses": 2, "slo": {"latencyClass": "realtime",
                                   "minTensorCorePercent": 30,
                                   "burstTensorCorePercent": 80}}}),
    chip_config({"strategy": "ProcessShared", "processSharedConfig": {
        "slo": {"latencyClass": "batch", "burstTensorCorePercent": 80}}}),
    chip_config({"strategy": "Exclusive",
                 "timeSharedConfig": {"interval": "Long"}}),
    chip_config({"strategy": "Exclusive", "bogus": 1}),
    chip_config({"strategy": "Sometimes"}),
    {"apiVersion": API, "kind": "TensorCoreConfig"},
    {"apiVersion": API, "kind": "TensorCoreConfig",
     "sharing": {"strategy": "TimeShared"}},
    {"apiVersion": API, "kind": "IciChannelConfig"},
    {"apiVersion": API, "kind": "IciChannelConfig", "extra": True},
    {"apiVersion": API, "kind": "GpuConfig"},
    {"apiVersion": "gpu.nvidia.com/v1alpha1", "kind": "TpuChipConfig"},
    "not-an-object",
]


def decoded(mod, doc):
    """(to_dict after normalize + validate) or (error type, message)."""
    try:
        cfg = mod.decode_config(doc)
        cfg.normalize()
        cfg.validate()
        return ("ok", cfg.to_dict())
    except Exception as e:  # the error itself is what is compared
        return (type(e).__name__, str(e))


class TestApiParity:
    @pytest.mark.parametrize("doc", DOCUMENTS,
                             ids=[f"doc{i}" for i in range(len(DOCUMENTS))])
    def test_documents_decode_equal(self, doc):
        assert decoded(api, doc) == decoded(ref_api, doc)

    def test_quantities_and_per_chip_limits_equal(self):
        for s in ("1Ki", "16Gi", "512Mi", "4G", "100M", "123", 123, "1.5Gi",
                  "2e3", "", "abc", "1X", "Gi", "--3"):
            assert decoded_call(api.parse_quantity, s) == \
                decoded_call(ref_api.parse_quantity, s)
        uuids = ["TPU-aaaa00000000", "TPU-bbbb00000000"]
        for entries, default in ((None, "1Gi"), ({"1": "2Gi"}, None),
                                 ({"0": "4G"}, "1Gi"), ({"7": "1Gi"}, None),
                                 ({"TPU-ffff": "1Gi"}, None),
                                 ({"0": "0"}, None)):
            assert decoded_call(
                lambda: api.PerChipHbmLimit(entries).normalize(uuids, default)
            ) == decoded_call(
                lambda: ref_api.PerChipHbmLimit(entries).normalize(uuids,
                                                                   default))
        assert set(api.__all__) == set(ref_api.__all__)


def decoded_call(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:
        return (type(e).__name__, str(e))


def make_claim(uid, devices, configs=None, admin=()):
    results = [{"request": "req-0", "driver": DRIVER, "pool": "node-a",
                "device": d} for d in devices]
    requests = [{"name": "req-0", "deviceClassName": DRIVER}]
    for name in admin:
        results.append({"request": "admin", "driver": DRIVER,
                        "pool": "node-a", "device": name})
    if admin:
        requests.append({"name": "admin", "deviceClassName": DRIVER,
                         "adminAccess": True})
    return {
        "apiVersion": "resource.k8s.io/v1beta1", "kind": "ResourceClaim",
        "metadata": {"name": f"claim-{uid}", "namespace": "default",
                     "uid": uid},
        "spec": {"devices": {"requests": requests}},
        "status": {"allocation": {"devices": {
            "results": results,
            "config": [{"source": "FromClaim", "requests": [],
                        "opaque": {"driver": DRIVER, "parameters": c}}
                       for c in (configs or [])],
        }}},
    }


class Side:
    """One package's device layer in its own directory."""

    def __init__(self, root, lib, cdi_cls, ckpt_cls, state_cls,
                 driver_root=None, dev_root="/", classes=None):
        self.root = str(root)
        self.lib = lib
        kw = {} if driver_root is None else dict(driver_root=driver_root)
        self.state = state_cls(
            chiplib=lib,
            cdi=cdi_cls(os.path.join(self.root, "cdi"), dev_root=dev_root,
                        **kw),
            checkpoint=ckpt_cls(os.path.join(self.root, "checkpoint.json")),
            driver_name=DRIVER, pool_name="node-a",
            state_dir=os.path.join(self.root, "state"),
            device_classes=classes,
        )

    def call(self, fn, *args, **kw):
        try:
            out = fn(*args, **kw)
        except Exception as e:
            return ("raised", type(e).__name__)
        if isinstance(out, list):
            return [d.to_dict() for d in out]
        return out

    def normalise(self, text: str) -> str:
        return text.replace(self.root, "<root>")

    def files(self) -> dict:
        """Every file the side wrote: CDI specs, the sharing state and
        session dirs; the checkpoint with its timestamps dropped."""
        out = {}
        for dirpath, _, names in os.walk(self.root):
            for name in names:
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, self.root)
                if rel == "checkpoint.json":
                    continue
                with open(path) as f:
                    out[rel] = self.normalise(f.read())
        ckpt = self.state.checkpoint.read()
        for rec in ckpt.values():
            rec.pop("preparedAt", None)
            (rec.get("resize") or {}).pop("startedAt", None)
        out["checkpoint"] = self.normalise(json.dumps(ckpt, sort_keys=True))
        return out

    def published(self):
        return self.state.published_resources()


def tpu_sides(tmp_path, driver_root=None):
    """Both packages on FakeChipLib("v5p", "2x2x1"). The driver root is
    an empty directory unless given: the reference also searches Python
    wheels for libtpu, the port does not (its driver root looks for the
    NVIDIA driver), so the host's own root would make them differ."""
    hostnames = ["worker-0", "worker-1"]
    if driver_root is None:
        driver_root = str(tmp_path / "empty-driver-root")
        os.makedirs(driver_root)
    ref = Side(tmp_path / "ref",
               RefFakeChipLib("v5p", "2x2x1", hostnames=hostnames),
               RefCDIHandler, RefCheckpointManager, RefDeviceState,
               driver_root=driver_root)
    mine = Side(tmp_path / "mine",
                FakeChipLib("v5p", "2x2x1", hostnames=hostnames),
                CDIHandler, CheckpointManager, DeviceState,
                driver_root=driver_root)
    return ref, mine


PROCESS_SHARED = chip_config({"strategy": "ProcessShared",
                              "processSharedConfig": {
                                  "maxProcesses": 2,
                                  "defaultHbmLimit": "16Gi",
                                  "defaultActiveCorePercentage": 50}})
TIME_SHARED = chip_config({"strategy": "TimeShared",
                           "timeSharedConfig": {"interval": "Short"}})

# (label, action on a DeviceState): the scripted claim sequence.
SEQUENCE = [
    ("exclusive chips", lambda s: s.prepare(make_claim(
        "a", ["tpu-0"], admin=["tpu-3"]))),
    ("prepare is idempotent", lambda s: s.prepare(make_claim(
        "a", ["tpu-0"], admin=["tpu-3"]))),
    ("tensorcore partition", lambda s: s.prepare(make_claim(
        "b", ["tpu-1-core-0"]))),
    ("ici channel", lambda s: s.prepare(make_claim(
        "c", ["ici-channel-5"]))),
    ("time-shared", lambda s: s.prepare(make_claim(
        "d", ["tpu-2"], [TIME_SHARED]))),
    ("mode conflict", lambda s: s.prepare(make_claim("g", ["tpu-2"]))),
    ("process-shared", lambda s: s.prepare(make_claim(
        "e", ["tpu-3"], [PROCESS_SHARED]))),
    ("resize limits", lambda s: s.resize_claim_limits("e", hbm_limit="8Gi")),
    ("resize core share", lambda s: s.resize_claim_limits(
        "e", tensorcore_percent=30)),
    ("resize refused on exclusive", lambda s: s.resize_claim_limits(
        "a", hbm_limit="1Gi")),
    ("gang resize", lambda s: s.resize_claim(
        "a", [{"device": "tpu-0", "driver": DRIVER, "request": "req-0"}])),
    ("tensorcore shared refused", lambda s: s.prepare(make_claim(
        "h", ["tpu-1-core-1"], [{"apiVersion": API,
                                 "kind": "TensorCoreConfig",
                                 "sharing": {"strategy": "TimeShared"}}]))),
    ("unknown device", lambda s: s.prepare(make_claim("i", ["tpu-9"]))),
]


def wedge(state):
    state.chiplib.wedge_chip(1, "hung runtime")
    return state.refresh_allocatable()


SEQUENCE += [
    ("wedge", wedge),
    ("wedged chip refused", lambda s: s.prepare(make_claim(
        "f", ["tpu-1"]))),
    ("unprepare a", lambda s: s.unprepare("a")),
    ("unprepare b", lambda s: s.unprepare("b")),
    ("unprepare c", lambda s: s.unprepare("c")),
    ("unprepare d", lambda s: s.unprepare("d")),
    ("unprepare e", lambda s: s.unprepare("e")),
    ("unprepare twice", lambda s: s.unprepare("e")),
]


class TestDeviceStateParity:
    def test_startup_equal(self, tmp_path):
        ref, mine = tpu_sides(tmp_path)
        assert mine.files() == ref.files()
        assert mine.published() == ref.published()

    def test_scripted_claim_sequence_equal(self, tmp_path):
        """Every step's result (kubelet devices or the exception's type),
        every file either side wrote, and the published resources."""
        ref, mine = tpu_sides(tmp_path)
        refused = []
        for label, action in SEQUENCE:
            got = mine.call(action, mine.state)
            want = ref.call(action, ref.state)
            assert got == want, label
            if isinstance(want, tuple):
                refused.append((label, want[1]))
            assert mine.files() == ref.files(), label
            assert mine.published() == ref.published(), label
        assert refused == [
            ("mode conflict", "ModeConflictError"),
            ("resize refused on exclusive", "LimitResizeError"),
            ("tensorcore shared refused", "ConfigError"),
            ("unknown device", "PrepareError"),
            ("wedged chip refused", "UnhealthyDeviceError"),
        ]

    def test_cdi_with_a_driver_root_equal(self, tmp_path):
        """A libtpu.so under the driver root is mounted by both."""
        droot = tmp_path / "driver"
        (droot / "usr" / "lib64").mkdir(parents=True)
        (droot / "usr" / "lib64" / "libtpu.so").write_text("")
        ref, mine = tpu_sides(tmp_path, driver_root=str(droot))
        for side in (ref, mine):
            side.state.prepare(make_claim("x", ["tpu-0", "tpu-1"],
                                          [PROCESS_SHARED]))
        assert mine.files() == ref.files()
        base = json.loads(mine.files()["cdi/k8s.tpu.google.com-base.json"])
        assert base["containerEdits"]["mounts"][0]["hostPath"] == \
            str(droot / "usr" / "lib64" / "libtpu.so")


# The runtime variables of a libtpu claim that a CUDA claim must not carry.
TPU_RUNTIME_KEYS = (
    "TPU_VISIBLE_CHIPS", "TPU_CHIPS_PER_HOST_BOUNDS", "TPU_ACCELERATOR_TYPE",
    "TPU_SLICE_ID", "TPU_TOPOLOGY", "TPU_WORKER_ID",
    "TPU_RUNTIME_METRICS_PORTS", "TPU_SKIP_MDS_QUERY",
    "XLA_PYTHON_CLIENT_MEM_FRACTION", "TPU_PREMAPPED_BUFFER_SIZE",
    "TPU_VISIBLE_CORES", "TPU_PROCESS_BOUNDS", "TPU_MEGACORE",
    "TPU_LIBRARY_PATH",
)


def spec_env(containers_edits) -> dict:
    return dict(e.split("=", 1) for e in containers_edits.get("env", []))


@pytest.fixture
def gpu_node(tmp_path):
    """A fake node of 8 H100s, its dev root holding nvidiactl and
    nvidia-uvm (no nvidia-uvm-tools), its driver root libcuda and
    libnvidia-ml."""
    dev = tmp_path / "host"
    (dev / "dev").mkdir(parents=True)
    for name in ("nvidiactl", "nvidia-uvm"):
        (dev / "dev" / name).write_text("")
    libdir = tmp_path / "driver" / "usr" / "lib" / "x86_64-linux-gnu"
    libdir.mkdir(parents=True)
    (libdir / "libcuda.so.570.124.06").write_text("")
    (libdir / "libcuda.so.1").symlink_to("libcuda.so.570.124.06")
    (libdir / "libnvidia-ml.so.1").write_text("")
    side = Side(tmp_path / "plugin", FakeChipLib("h100", "8x1x1"),
                CDIHandler, CheckpointManager, DeviceState,
                driver_root=str(tmp_path / "driver"), dev_root=str(dev),
                classes={"chip"})
    return side, dev, libdir


class TestCudaMapping:
    def test_base_spec(self, gpu_node):
        side, dev, libdir = gpu_node
        base = json.loads(side.files()["cdi/k8s.tpu.google.com-base.json"])
        common = base["containerEdits"]
        assert [n["path"] for n in common["deviceNodes"]] == \
            [str(dev / "dev" / "nvidiactl"), str(dev / "dev" / "nvidia-uvm")]
        assert common["mounts"] == [
            {"hostPath": str(libdir / "libcuda.so.570.124.06"),
             "containerPath": "/usr/lib/x86_64-linux-gnu/libcuda.so.1",
             "options": ["ro", "nosuid", "nodev", "bind"]},
            {"hostPath": str(libdir / "libnvidia-ml.so.1"),
             "containerPath": "/usr/lib/x86_64-linux-gnu/libnvidia-ml.so.1",
             "options": ["ro", "nosuid", "nodev", "bind"]},
        ]
        assert spec_env(common) == {"TPU_DRA_MANAGED": "1"}
        assert [d["containerEdits"]["deviceNodes"][0]["path"]
                for d in base["devices"]] == \
            [f"/dev/nvidia{i}" for i in range(8)]
        published = side.published()
        assert len(published["devices"]) == 8
        assert published["sharedCounters"] == []

    def test_exclusive_claim(self, gpu_node):
        side, _, _ = gpu_node
        chips = {c.index: c for c in side.lib.enumerate_chips()}
        side.state.prepare(make_claim("x", ["tpu-5", "tpu-2"]))
        spec = json.loads(side.files()["cdi/k8s.tpu.google.com-claim_x.json"])
        env = spec_env(spec["containerEdits"])
        assert env["CUDA_VISIBLE_DEVICES"] == \
            f"{chips[2].uuid},{chips[5].uuid}"
        for d in spec["devices"]:
            assert spec_env(d["containerEdits"]) == \
                {"TPU_DRA_SHARING": "exclusive"}
        assert len(spec["containerEdits"]["mounts"]) == 2
        assert not set(env) & set(TPU_RUNTIME_KEYS)
        side.state.unprepare("x")
        assert "cdi/k8s.tpu.google.com-claim_x.json" not in side.files()

    def test_process_shared_claim(self, gpu_node):
        side, _, _ = gpu_node
        side.state.prepare(make_claim("p", ["tpu-0"], [chip_config({
            "strategy": "ProcessShared", "processSharedConfig": {
                "maxProcesses": 2, "defaultHbmLimit": "36Gi",
                "defaultActiveCorePercentage": 40}})]))
        spec = json.loads(side.files()["cdi/k8s.tpu.google.com-claim_p.json"])
        env = spec_env(spec["devices"][0]["containerEdits"])
        assert env == {
            "TPU_DRA_SHARING": "process-shared",
            "TPU_DRA_MAX_PROCESSES": "2",
            "TPU_DRA_SHARED_DIR": "/var/run/tpu-dra-shared",
            "TPU_DRA_HBM_LIMIT_BYTES": str(36 << 30),
            "TPU_DRA_CHIP_HBM_BYTES": str(80 << 30),
            "TPU_DRA_ACTIVE_CORE_PERCENTAGE": "40",
            "CUDA_MPS_ACTIVE_THREAD_PERCENTAGE": "40",
            "TPU_DRA_RUNTIME": "cuda",
        }
        common = spec_env(spec["containerEdits"])
        assert not (set(env) | set(common)) & set(TPU_RUNTIME_KEYS)
        limits = json.loads(next(v for k, v in side.files().items()
                                 if k.endswith("limits.json")))
        assert limits["hbmLimitBytes"] == 36 << 30
        out = side.state.resize_claim_limits("p", hbm_limit="24Gi")
        assert out["generation"] == 2
        spec = json.loads(side.files()["cdi/k8s.tpu.google.com-claim_p.json"])
        assert spec_env(spec["devices"][0]["containerEdits"])[
            "TPU_DRA_HBM_LIMIT_BYTES"] == str(24 << 30)

    def test_time_shared_claim(self, gpu_node):
        side, _, _ = gpu_node
        side.state.prepare(make_claim("t", ["tpu-1", "tpu-0"],
                                      [TIME_SHARED]))
        chips = side.lib.enumerate_chips()
        spec = json.loads(side.files()["cdi/k8s.tpu.google.com-claim_t.json"])
        env = spec_env(spec["devices"][0]["containerEdits"])
        assert env["TPU_DRA_RUNTIME"] == "cuda"
        assert env["TPU_DRA_CHIP_UUIDS"] == ",".join(
            sorted(c.uuid for c in chips[:2]))
        assert spec_env(spec["containerEdits"])["CUDA_VISIBLE_DEVICES"] == \
            f"{chips[0].uuid},{chips[1].uuid}"
        assert sorted(side.lib.sharing_modes) == sorted(
            c.uuid for c in chips[:2])
