"""The port's MIG devices: a GPU in MIG mode published as its existing
GPU/compute instances, allocated through the counter sets, prepared by
MIG uuid, all on the CPU.

``RealChipLib`` runs over ``FakeNvml`` (``test_torch_tpulib.py``) with GPU
instances and a ``mig-minors`` file under the dev root; ``FakeChipLib``'s
``mig`` layout stands in for the node where a Driver runs. The TPU side
stays the reference's: a v5p partition claim prepares to the JAX
package's spec byte for byte.
"""

from __future__ import annotations

import ctypes
import json
import os
import time
import types

import pytest

from test_cel import load_device_classes
from test_torch_tpulib import FakeNvml, write_mig_minors

from k8s_dra_driver_tpu.cdi import CDIHandler as RefCDIHandler
from k8s_dra_driver_tpu.plugin.checkpoint import (
    CheckpointManager as RefCheckpointManager,
)
from k8s_dra_driver_tpu.plugin.device_state import DeviceState as RefDeviceState
from k8s_dra_driver_tpu.tpulib import FakeChipLib as RefFakeChipLib
from k8s_dra_driver_tpu.tpulib import deviceinfo as ref_deviceinfo
from k8s_dra_driver_tpu_torch.api.v1alpha1 import ConfigError
from k8s_dra_driver_tpu_torch.cdi import CDIHandler
from k8s_dra_driver_tpu_torch.kube import NODES, RESOURCE_SLICES, FakeKubeClient
from k8s_dra_driver_tpu_torch.kube.allocator import (
    AllocationError,
    ReferenceAllocator,
    Selector,
)
from k8s_dra_driver_tpu_torch.kube.resourceslice import (
    DriverResources,
    Pool,
    ResourceSliceController,
)
from k8s_dra_driver_tpu_torch.kube.schema import validate_for_resource
from k8s_dra_driver_tpu_torch.plugin import CheckpointManager, DeviceState
from k8s_dra_driver_tpu_torch.plugin.device_state import UnhealthyDeviceError
from k8s_dra_driver_tpu_torch.tpulib import _nvml, chiplib, deviceinfo

DRIVER = "tpu.google.com"
TENSORCORE_CLASS = "tensorcore.tpu.google.com"
# GPU 0 (handle 100, minor 3) in MIG mode; GPU 1 (handle 101) whole.
LAYOUT = [("3g.40gb", 0), ("2g.20gb", 4), ("1g.10gb", 6)]
NAMES = ["tpu-0-mig-9-0-4", "tpu-0-mig-14-4-2", "tpu-0-mig-19-6-1"]
TPU_CORE_KEYS = ("TPU_VISIBLE_CORES", "TPU_PROCESS_BOUNDS", "TPU_MEGACORE")


@pytest.fixture
def mig_host(tmp_path):
    """A dev root with both GPUs' nodes, ``mig-minors`` and its access
    nodes, and a FakeNvml whose GPU 0 holds ``LAYOUT``."""
    (tmp_path / "dev").mkdir()
    for minor in (3, 4):
        (tmp_path / "dev" / f"nvidia{minor}").write_text("")
    write_mig_minors(tmp_path, gpus=5)
    nv = FakeNvml()
    nv.set_mig(100, LAYOUT)
    return tmp_path, nv


def real_lib(root, nv):
    return chiplib.RealChipLib(
        chiplib.ChipLibConfig(dev_root=str(root),
                              state_dir=str(root / "modes")), nvml=nv)


def device_state(root, lib, name="plugin"):
    return DeviceState(
        chiplib=lib, cdi=CDIHandler(str(root / name / "cdi"),
                                    dev_root=str(root)),
        checkpoint=CheckpointManager(str(root / name / "checkpoint.json")),
        driver_name=DRIVER, pool_name="node-a",
        state_dir=str(root / name / "state"),
        device_classes={"chip", "tensorcore"})


def claim(uid, devices, configs=()):
    return {
        "metadata": {"name": f"claim-{uid}", "namespace": "default",
                     "uid": uid},
        "spec": {"devices": {"requests": [
            {"name": "req-0", "deviceClassName": TENSORCORE_CLASS}]}},
        "status": {"allocation": {"devices": {
            "results": [{"request": "req-0", "driver": DRIVER,
                         "pool": "node-a", "device": d} for d in devices],
            "config": [{"source": "FromClaim", "requests": [],
                        "opaque": {"driver": DRIVER, "parameters": c}}
                       for c in configs]}}},
    }


def publish(client, node, allocatable):
    client.create(NODES, {"metadata": {"name": node, "uid": f"u-{node}"}})
    ctrl = ResourceSliceController(
        client, DRIVER, scope=node,
        owner={"kind": "Node", "name": node, "uid": f"u-{node}"})
    ctrl.update(DriverResources(pools={node: Pool(
        devices=[d.get_device() for _, d in sorted(allocatable.items())],
        shared_counters=deviceinfo.counter_sets(allocatable),
        node_name=node)}))
    ctrl.sync_once()


def class_claim(uid, selectors=None):
    return {
        "metadata": {"name": f"claim-{uid}", "namespace": "mig",
                     "uid": uid},
        "spec": {"devices": {"requests": [
            {"name": "p", "deviceClassName": TENSORCORE_CLASS}]}},
    }, ({"p": selectors} if selectors else None)


def granted(c):
    return [r["device"] for r in
            c["status"]["allocation"]["devices"]["results"]]


class TestPublication:
    def test_mig_gpu_publishes_its_instances(self, mig_host):
        """(a) Three tensorcore devices with DNS-1123 names and the keys
        of a TPU partition, no whole GPU 0, the counter set declared, and
        a slice the allocator takes: the shipped DeviceClass selects
        each."""
        root, nv = mig_host
        lib = real_lib(root, nv)
        lib.init()
        devs = lib.enumerate_all_possible_devices({"chip", "tensorcore"})
        assert sorted(devs) == sorted(NAMES + ["tpu-1"])
        assert "tpu-0" not in devs
        ref_tc = ref_deviceinfo.TensorCoreInfo(
            parent=RefFakeChipLib("v5p", "2x2x1").enumerate_chips()[0],
            core_index=1).get_device()["basic"]
        for name in NAMES:
            dev = devs[name].get_device()["basic"]
            assert devs[name].type() == "tensorcore"
            assert set(dev["attributes"]) == set(ref_tc["attributes"])
            assert set(dev["capacity"]) == set(ref_tc["capacity"])
        big = devs["tpu-0-mig-9-0-4"].get_device()["basic"]
        attrs = big["attributes"]
        assert (attrs["profile"], attrs["profileCores"], attrs["index"],
                attrs["uuid"]) == (
            {"string": "3g.40gb"}, {"int": 3}, {"int": 0},
            {"string": nv.migs[10000]["uuid"]})
        assert big["capacity"]["hbm"] == \
            {"value": str(nv.migs[10000]["total"])}
        assert big["capacity"]["tensorcores"] == {"value": "3"}
        assert big["capacity"]["peakBf16Flops"] == \
            {"value": str(int(989e12) * 3 // 7)}
        assert big["consumesCounters"] == [{
            "counterSet": "chip-0-counters",
            "counters": {f"memorySlice{i}": {"value": "1"}
                         for i in range(4)}}]
        assert deviceinfo.counter_sets(devs) == [{
            "name": "chip-0-counters",
            "counters": {f"memorySlice{i}": {"value": "1"}
                         for i in range(8)}}]

        client = FakeKubeClient()
        publish(client, "node-a", devs)
        (published,) = client.list(RESOURCE_SLICES)
        validate_for_resource("resourceslices", published)
        alloc = ReferenceAllocator(client, driver_name=DRIVER,
                                   device_classes=load_device_classes())
        got = []
        for i in range(3):
            c, sel = class_claim(f"m{i}")
            alloc.allocate(c)
            got += granted(c)
        assert sorted(got) == sorted(NAMES)
        c, _ = class_claim("m3")
        with pytest.raises(AllocationError):
            alloc.allocate(c)
        # The whole GPU 1 is still a chip of the chip class.
        whole = {"metadata": {"name": "w", "namespace": "mig", "uid": "w"},
                 "spec": {"devices": {"requests": [
                     {"name": "c", "deviceClassName": DRIVER}]}}}
        alloc.allocate(whole)
        assert granted(whole) == ["tpu-1"]

    def test_a_second_compute_instance_is_a_device_of_its_own(self,
                                                               mig_host):
        root, nv = mig_host
        extra = dict(nv.migs[10000], ci=1,
                     uuid="MIG-00000064-0001-4000-8000-0000000000ff")
        nv.migs[10003] = extra
        lib = real_lib(root, nv)
        lib.init()
        devs = lib.enumerate_all_possible_devices({"tensorcore"})
        second = devs["tpu-0-mig-9-0-4-ci1"].tensorcore
        assert second.uuid == extra["uuid"]
        assert second.caps_paths[1].endswith(
            f"nvidia-cap{chiplib.mig_cap_minor(3, 1, 1)}")
        # One GPU instance: the two compute instances consume the same
        # memory slices, so they are never granted together.
        assert devs["tpu-0-mig-9-0-4"].get_device()["basic"][
            "consumesCounters"] == second.get_device()["basic"][
            "consumesCounters"]

    def test_gpu_outside_mig_mode_publishes_as_before(self, mig_host):
        root, _ = mig_host
        lib = real_lib(root, FakeNvml())
        lib.init()
        devs = lib.enumerate_all_possible_devices({"chip", "tensorcore"})
        assert sorted(devs) == ["tpu-0", "tpu-1"]
        assert deviceinfo.counter_sets(devs) == []

    def test_unreadable_mig_minors_raises(self, mig_host):
        root, nv = mig_host
        os.unlink(root / "proc" / "driver" / "nvidia-caps" / "mig-minors")
        lib = real_lib(root, nv)
        lib.init()
        with pytest.raises(chiplib.MigCapsError, match="mig-minors"):
            lib.enumerate_chips()
        (root / "proc" / "driver" / "nvidia-caps" / "mig-minors").write_text(
            "config 1\nmonitor 2\ngpu3/gi1/access 21\n")
        with pytest.raises(chiplib.MigCapsError, match="gpu3/gi1/ci0"):
            lib.enumerate_chips()

    def test_mig_minors_parse(self):
        text = ("config 1\nmonitor 2\ngpu0/gi3/access 30\n"
                "gpu0/gi3/ci0/access 31\n\nbogus line here\n")
        assert chiplib.parse_mig_minors(text) == {
            "config": 1, "monitor": 2, "gpu0/gi3/access": 30,
            "gpu0/gi3/ci0/access": 31}
        assert (chiplib.mig_cap_minor(0, 3),
                chiplib.mig_cap_minor(0, 3, 0)) == (30, 31)

    def test_health_is_the_parents(self, mig_host):
        root, nv = mig_host
        state = device_state(root, real_lib(root, nv))
        assert all(state.allocatable[n].get_device()["basic"]["attributes"]
                   ["healthy"] == {"bool": True} for n in NAMES)
        nv.devices[100]["ecc"] = 1
        state.refresh_allocatable()
        nv.devices[100]["ecc"] = 2
        state.refresh_allocatable()
        assert all(state.allocatable[n].get_device()["basic"]["attributes"]
                   ["healthy"] == {"bool": False} for n in NAMES)
        with pytest.raises(UnhealthyDeviceError):
            state.prepare(claim("sick", [NAMES[0]]))

    def test_fake_layouts(self):
        lib = chiplib.FakeChipLib("h100", "2x1x1", mig={1: LAYOUT})
        devs = lib.enumerate_all_possible_devices({"chip", "tensorcore"})
        assert sorted(devs) == sorted(
            ["tpu-0"] + [n.replace("tpu-0", "tpu-1") for n in NAMES])
        caps = devs["tpu-1-mig-14-4-2"].tensorcore.caps_paths
        assert caps == [
            f"/dev/nvidia-caps/nvidia-cap{chiplib.mig_cap_minor(1, 2)}",
            f"/dev/nvidia-caps/nvidia-cap{chiplib.mig_cap_minor(1, 2, 0)}"]
        for bad in ([("3g.40gb", 0), ("4g.40gb", 0)],
                    [("2g.20gb", 6)], [("5g.50gb", 0)]):
            with pytest.raises(ValueError):
                chiplib.FakeChipLib("h100", "1x1x1", mig={0: bad})


# Each call of the GI/CI walk, answering NoPermission.
WALK_CALLS = ["max_mig_device_count", "mig_device_handle_by_index",
              "gpu_instance_id", "compute_instance_id", "gpu_instance",
              "gpu_instance_profile"]


class TestNoPermission:
    @pytest.mark.parametrize("call", WALK_CALLS)
    def test_a_refused_walk_raises(self, mig_host, call):
        """(d) Refused is not "no partitions": the enumeration raises,
        naming the call, and a plugin over it does not start."""
        root, nv = mig_host
        nv.denied = {call}
        lib = real_lib(root, nv)
        lib.init()
        with pytest.raises(_nvml.NvmlError, match="NoPermission") as e:
            lib.enumerate_chips()
        assert e.value.function == call
        with pytest.raises(_nvml.NvmlError, match="NoPermission"):
            device_state(root, real_lib(root, nv))


def every_placement(chip):
    """Every placement of every H100 profile on ``chip``: what a driver
    that created instances on demand would publish."""
    return [
        deviceinfo.MigDeviceInfo(
            parent=chip, core_index=start, profile=p,
            mig_uuid=f"MIG-{chip.index}-{p.profile_id}-{start}",
            memory_bytes=chip.hbm_bytes * p.memory_slices // 8, gi_id=0)
        for p in deviceinfo.partition_profiles("h100")
        for start in p.slice_placements
    ]


class EveryPlacementLib(chiplib.FakeChipLib):
    def publishes_whole(self, chip):
        return False

    def enumerate_core_partitions(self, chip):
        return every_placement(chip)


class TestCounterExclusivity:
    def test_h100_profiles_allocate_with_counter_exclusivity(self,
                                                             tmp_path):
        """(b) The twin of test_cluster_sim.py's synthetic-profile case
        on the H100 table: a Driver publishes every placement, and the
        memory-slice counters keep overlapping placements apart while
        the second GPU stays free."""
        from k8s_dra_driver_tpu_torch.plugin.driver import Driver, DriverConfig
        from k8s_dra_driver_tpu_torch.plugin.kubeletplugin import (
            LocalTransport,
        )

        client = FakeKubeClient()
        client.create(NODES, {"metadata": {"name": "node-a",
                                           "uid": "u-a"}})
        cfg = DriverConfig(
            node_name="node-a",
            chiplib=EveryPlacementLib(generation="h100", topology="2x1x1",
                                      slice_id="s"),
            kube_client=client, cdi_root=str(tmp_path / "cdi"),
            plugin_root=str(tmp_path / "plugin"),
            registrar_root=str(tmp_path / "reg"),
            state_root=str(tmp_path / "state"), node_uid="u-a",
            cleanup_interval_seconds=0,
            # tmp_path may pass the AF_UNIX path limit: no socket here.
            transport=LocalTransport())
        d = Driver(cfg)
        d.start()
        try:
            deadline = time.monotonic() + 10
            while True:
                names = {dev["name"] for s in client.list(RESOURCE_SLICES)
                         for dev in s["spec"].get("devices", [])}
                if names or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            assert "tpu-0-mig-0-0-8" in names and "tpu-1-mig-19-6-1" in names
            assert len(names) == 2 * 18
            alloc = ReferenceAllocator(client,
                                       device_classes=load_device_classes())

            def take(uid, profile, start, gpu=0):
                c, sel = class_claim(uid, [
                    Selector("profile", "eq", profile),
                    Selector("index", "eq", start),
                    Selector("parentIndex", "eq", gpu)])
                alloc.allocate(c, selectors=sel)
                return granted(c)

            assert take("a", "3g.40gb", 0) == ["tpu-0-mig-9-0-4"]
            # Overlapping placements on GPU 0 refuse: every one that
            # touches memory slices 0-3.
            for profile, start in (("4g.40gb", 0), ("7g.80gb", 0),
                                   ("1g.10gb", 3), ("2g.20gb", 2),
                                   ("1g.20gb", 0)):
                with pytest.raises(AllocationError):
                    take(f"x-{profile}-{start}", profile, start)
            # Disjoint ones fit beside it, up to the GPU's 8 slices.
            assert take("b", "2g.20gb", 4) == ["tpu-0-mig-14-4-2"]
            assert take("c", "1g.10gb", 6) == ["tpu-0-mig-19-6-1"]
            with pytest.raises(AllocationError):
                take("y", "1g.20gb", 6)
            # The second GPU is untouched: its whole-GPU profile fits.
            assert take("d", "7g.80gb", 0, gpu=1) == ["tpu-1-mig-0-0-8"]
            # Releasing frees the slices: 4g.40gb@0 now fits GPU 0.
            alloc.deallocate("a")
            assert take("e", "4g.40gb", 0) == ["tpu-0-mig-5-0-4"]
        finally:
            d.shutdown()


def spec_env(edits) -> dict:
    return dict(e.split("=", 1) for e in edits.get("env", []))


class TestPrepare:
    def test_prepare_unprepare_restart(self, mig_host):
        """(c) The CDI spec of a MIG prepare: the GPU's node and both
        access nodes, CUDA_VISIBLE_DEVICES=MIG-..., no TPU core
        variable; unprepare removes it; a restart serves it from the
        checkpoint and unprepares it."""
        root, nv = mig_host
        state = device_state(root, real_lib(root, nv))
        cdi = root / "plugin" / "cdi"
        devices = state.prepare(claim("u1", [NAMES[1]]))
        assert [d.device_name for d in devices] == [NAMES[1]]
        base = json.loads((cdi / "k8s.tpu.google.com-base.json").read_text())
        entry = next(d for d in base["devices"] if d["name"] == NAMES[1])
        assert [n["path"] for n in entry["containerEdits"]["deviceNodes"]] \
            == [str(root / "dev" / "nvidia3"),
                str(root / "dev" / "nvidia-caps" /
                    f"nvidia-cap{chiplib.mig_cap_minor(3, 2)}"),
                str(root / "dev" / "nvidia-caps" /
                    f"nvidia-cap{chiplib.mig_cap_minor(3, 2, 0)}")]
        spec_path = cdi / "k8s.tpu.google.com-claim_u1.json"
        spec = json.loads(spec_path.read_text())
        env = spec_env(spec["containerEdits"])
        assert env["CUDA_VISIBLE_DEVICES"] == nv.migs[10001]["uuid"]
        assert not set(env) & {*TPU_CORE_KEYS, "TPU_VISIBLE_CHIPS"}
        dev_env = spec_env(spec["devices"][0]["containerEdits"])
        assert dev_env == {"TPU_DRA_SHARING": "exclusive"}
        assert devices[0].cdi_device_ids == [
            f"k8s.{DRIVER}/chip={NAMES[1]}",
            f"k8s.{DRIVER}/claim=u1-{NAMES[1]}"]
        # The exclusive hold is the instance's, not its GPU's.
        assert state.share_state.list_chips() == [nv.migs[10001]["uuid"]]
        state.unprepare("u1")
        assert not spec_path.exists()
        assert state.share_state.list_chips() == []

        state.prepare(claim("u2", [NAMES[0]]))
        restarted = device_state(root, real_lib(root, nv))
        assert list(restarted.checkpoint.read()) == ["u2"]
        again = restarted.prepare(claim("u2", [NAMES[0]]))
        assert [d.device_name for d in again] == [NAMES[0]]
        assert (cdi / "k8s.tpu.google.com-claim_u2.json").exists()
        assert [c.claim_uid for c in
                restarted.prepared_claims_on_chip(nv.devices[100]["uuid"])] \
            == ["u2"]
        assert restarted.prepared_claims_on_chip(
            nv.devices[101]["uuid"]) == []
        restarted.unprepare("u2")
        assert not (cdi / "k8s.tpu.google.com-claim_u2.json").exists()
        assert restarted.checkpoint.read() == {}

    def test_two_mig_devices_list_both_uuids(self, mig_host):
        root, nv = mig_host
        state = device_state(root, real_lib(root, nv))
        state.prepare(claim("two", [NAMES[2], NAMES[0]]))
        spec = json.loads((root / "plugin" / "cdi" /
                           "k8s.tpu.google.com-claim_two.json").read_text())
        assert spec_env(spec["containerEdits"])["CUDA_VISIBLE_DEVICES"] \
            == f"{nv.migs[10000]['uuid']},{nv.migs[10002]['uuid']}"

    def test_only_exclusive(self, mig_host):
        """A partition's config admits Exclusive only (the reference's
        TensorCoreConfig): no sharing envelope, so no HBM cap, is ever
        rendered for a MIG device, and the exclusive spec names no
        memory size of its GPU."""
        root, nv = mig_host
        state = device_state(root, real_lib(root, nv))
        shared = {"apiVersion": "tpu.google.com/v1alpha1",
                  "kind": "TensorCoreConfig",
                  "sharing": {"strategy": "ProcessShared"}}
        with pytest.raises(ConfigError):
            state.prepare(claim("ps", [NAMES[0]], [shared]))
        state.prepare(claim("ex", [NAMES[0]]))
        text = (root / "plugin" / "cdi" /
                "k8s.tpu.google.com-claim_ex.json").read_text()
        assert "HBM" not in text
        assert str(nv.devices[100]["total"]) not in text


class TestTpuPartitionsUnchanged:
    @pytest.mark.parametrize("devices", [["tpu-1-core-0"],
                                         ["tpu-0-core-1", "tpu-2-core-0"]])
    def test_v5p_partition_prepares_as_the_reference(self, tmp_path,
                                                     devices):
        """(e) A v5p partition claim: the same CDI files and kubelet
        devices as the JAX package's, with the TPU core variables."""
        out = {}
        for name, (lib, cdi_cls, ckpt_cls, state_cls) in {
                "ref": (RefFakeChipLib("v5p", "2x2x1"), RefCDIHandler,
                        RefCheckpointManager, RefDeviceState),
                "mine": (chiplib.FakeChipLib("v5p", "2x2x1"), CDIHandler,
                         CheckpointManager, DeviceState)}.items():
            droot = tmp_path / name / "driver"
            droot.mkdir(parents=True)
            state = state_cls(
                chiplib=lib,
                cdi=cdi_cls(str(tmp_path / name / "cdi"),
                            driver_root=str(droot)),
                checkpoint=ckpt_cls(str(tmp_path / name / "ckpt.json")),
                driver_name=DRIVER, pool_name="node-a",
                state_dir=str(tmp_path / name / "state"))
            got = [d.to_dict() for d in
                   state.prepare(claim("tc", devices))]
            files = {f: (tmp_path / name / "cdi" / f).read_text().replace(
                         str(tmp_path / name), "<root>")
                     for f in sorted(os.listdir(tmp_path / name / "cdi"))}
            out[name] = (got, files)
        assert out["mine"] == out["ref"]
        spec = json.loads(out["mine"][1]["k8s.tpu.google.com-claim_tc.json"])
        assert set(TPU_CORE_KEYS) <= set(spec_env(spec["containerEdits"]))


def _cfunc(restype_args, impl):
    return ctypes.CFUNCTYPE(ctypes.c_int, *restype_args)(impl)


class TestBinding:
    def test_mig_calls_marshal_through_ctypes(self):
        """The MIG entry points over C-callable stand-ins: each fills its
        out-parameters as NVML does and the binding reads them back."""
        u = ctypes.c_uint
        h = ctypes.c_void_p
        P = ctypes.POINTER
        seen = {}

        def mig_mode(handle, cur, pend):
            cur[0], pend[0] = 0, 1
            return 0

        def by_index(handle, index, out):
            if index == 2:
                return 6       # NVML_ERROR_NOT_FOUND
            out[0] = 5000 + index
            return 0

        def gi_by_id(handle, gi, out):
            out[0] = 7000 + gi
            return 0

        def gi_info(gi, info):
            info[0].id = gi - 7000
            info[0].profileId = 14
            info[0].placement.start, info[0].placement.size = 4, 2
            return 0

        def profile(handle, index, info):
            seen["version"] = info[0].version
            info[0].id, info[0].sliceCount = 9, 3
            info[0].instanceCount, info[0].multiprocessorCount = 2, 60
            info[0].memorySizeMB = 40192
            info[0].name = b"MIG 3g.40gb"
            return 0 if index == 2 else 3

        def uint_out(value):
            def fn(handle, out):
                out[0] = value
                return 0
            return fn

        def handle_out(handle, out):
            out[0] = 100
            return 0

        lib = types.SimpleNamespace(
            nvmlDeviceGetMigMode=_cfunc([h, P(u), P(u)], mig_mode),
            nvmlDeviceGetMaxMigDeviceCount=_cfunc([h, P(u)], uint_out(7)),
            nvmlDeviceGetMigDeviceHandleByIndex=_cfunc([h, u, P(h)],
                                                       by_index),
            nvmlDeviceGetDeviceHandleFromMigDeviceHandle=_cfunc(
                [h, P(h)], handle_out),
            nvmlDeviceGetGpuInstanceId=_cfunc([h, P(u)], uint_out(3)),
            nvmlDeviceGetComputeInstanceId=_cfunc([h, P(u)], uint_out(1)),
            nvmlDeviceGetGpuInstanceById=_cfunc(
                [h, u, P(h)], gi_by_id),
            nvmlGpuInstanceGetInfo=_cfunc(
                [h, P(_nvml.GpuInstanceInfo)], gi_info),
            nvmlDeviceGetGpuInstanceProfileInfoV=_cfunc(
                [h, u, P(_nvml.GpuInstanceProfileInfoV2)], profile),
        )
        nv = _nvml.Nvml(lib)
        assert nv.mig_modes(100) == (0, 1)
        assert nv.mig_mode(100) == 0
        assert nv.max_mig_device_count(100) == 7
        assert nv.mig_device_handle_by_index(100, 1) == 5001
        with pytest.raises(_nvml.NvmlNotFound):
            nv.mig_device_handle_by_index(100, 2)
        assert nv.device_handle_from_mig_handle(5001) == 100
        assert (nv.gpu_instance_id(5001), nv.compute_instance_id(5001)) \
            == (3, 1)
        assert nv.gpu_instance(100, 3) == _nvml.GpuInstance(3, 14, 4, 2)
        assert nv.gpu_instance_profile(100, 2) == _nvml.GpuInstanceProfile(
            9, 3, 2, 60, 40192, "MIG 3g.40gb")
        assert seen["version"] == _nvml.GPU_INSTANCE_PROFILE_INFO_V2
        with pytest.raises(_nvml.NvmlNotSupported):
            nv.gpu_instance_profile(100, 5)
        # The binding has no call that creates or destroys an instance or
        # sets the MIG mode.
        assert not [n for n in _nvml.SIGNATURES
                    if any(w in n for w in ("Create", "Destroy", "SetMig"))
                    and "EventSet" not in n]


class TestInspect:
    def test_mig_devices_listed_with_profile_and_placement(self, mig_host):
        from k8s_dra_driver_tpu_torch.plugin import inspect

        root, nv = mig_host
        state = device_state(root, real_lib(root, nv))
        state.prepare(claim("seen", [NAMES[2]]))
        out = inspect.collect(str(root / "plugin"), str(root / "plugin" /
                                                       "cdi"),
                              chiplib=real_lib(root, nv))
        assert [(m["name"], m["profile"], m["placement"], m["parent"])
                for m in out["migDevices"]] == [
            (NAMES[0], "3g.40gb", "0:4", "tpu-0"),
            (NAMES[1], "2g.20gb", "4:2", "tpu-0"),
            (NAMES[2], "1g.10gb", "6:1", "tpu-0")]
        text = inspect.render(out)
        assert f"{NAMES[2]} {nv.migs[10002]['uuid']} on tpu-0 " \
            "profile=1g.10gb placement=6:1 gi=3 ci=0" in text
        assert "MIG devices: 3" in text
        # A node without MIG mode renders as before: no such section.
        plain = inspect.collect(str(root / "plugin"),
                                str(root / "plugin" / "cdi"),
                                chiplib=real_lib(root, FakeNvml()))
        assert "migDevices" not in plain
        assert "MIG devices" not in inspect.render(plain)


class TestAudit:
    def test_health_ordering_reads_a_mig_device_by_its_gpu(self, mig_host):
        """A MIG uuid names no GPU: the auditor finds the parent by the
        device's name, so a claim on a MIG device of a GPU that was
        already sick when it prepared is reported, and one on the other
        GPU's sickness is not."""
        from k8s_dra_driver_tpu_torch.plugin.audit import StateAuditor
        from k8s_dra_driver_tpu_torch.tpulib.chiplib import (
            HEALTH_DEGRADED,
            HealthStatus,
        )
        from k8s_dra_driver_tpu_torch.utils.metrics import Registry

        root, nv = mig_host
        state = device_state(root, real_lib(root, nv))
        state.prepare(claim("late", [NAMES[1]]))
        auditor = StateAuditor(state=state, registry=Registry(),
                               node_name="node-a", node_uid="nu-1")
        assert not [f for f in auditor.run_once() if f.check == "health"]
        gpu1 = nv.devices[101]["uuid"]
        state.chip_health[gpu1] = HealthStatus(HEALTH_DEGRADED, "sick", 0.0)
        assert not [f for f in auditor.run_once() if f.check == "health"]
        gpu0 = nv.devices[100]["uuid"]
        state.chip_health[gpu0] = HealthStatus(HEALTH_DEGRADED, "sick", 0.0)
        (finding,) = [f for f in auditor.run_once() if f.check == "health"]
        assert finding.subject == "late" and gpu0 in finding.detail
        assert state.parent_uuid_of_mig(NAMES[1]) == gpu0
        assert state.parent_uuid_of_mig("tpu-1") is None
