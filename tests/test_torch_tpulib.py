"""The port's ``tpulib`` against the reference's, and its NVML backend.

Topology math, device rendering and the fake chip library go through both
packages on the reference's own scenarios (``tests/test_tpulib.py``) and
must agree exactly. The GPU side is checked on its own: a fake node of 8
H100s, ``RealChipLib`` over an injected fake NVML, the ctypes binding's
struct layouts and return codes, and the driver root's NVIDIA libraries.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import threading
import time
import types

import pytest

from k8s_dra_driver_tpu.tpulib import chiplib as ref_chiplib
from k8s_dra_driver_tpu.tpulib import deviceinfo as ref_deviceinfo
from k8s_dra_driver_tpu.tpulib import topology as ref_topology
from k8s_dra_driver_tpu_torch.tpulib import _nvml
from k8s_dra_driver_tpu_torch.tpulib import chiplib, deviceinfo, topology
from k8s_dra_driver_tpu_torch.tpulib.driverroot import DriverRoot

# (generation, topology, extra FakeChipLib arguments): every scenario of
# the reference's tests/test_tpulib.py and a few more shapes.
SCENARIOS = [
    ("v5p", "2x2x1", {}),
    ("v5p", "4x2x1", dict(host_id=0, hosts_per_slice=2, slice_id="slice-a")),
    ("v5p", "4x2x1", dict(host_id=1, hosts_per_slice=2, slice_id="slice-a")),
    ("v5p", "2x1x1", {}),
    ("v5e", "2x2x1", {}),
    ("v4", "2x2x1", dict(slice_id="s1")),
    ("v5e", "1x1x1", dict(slice_id="slice-z")),
    ("v6e", "4x4x1", dict(hostnames=["h0", "h1"])),
    ("v4", "4x4x4", dict(host_id=3, hosts_per_slice=16)),
    ("v5p", "2x2x2", dict(chips_per_host=4, host_id=1, hosts_per_slice=2)),
]
SCENARIO_IDS = [f"{g}-{t}-{i}" for i, (g, t, _) in enumerate(SCENARIOS)]


def both_fakes(generation, topo, kw):
    return (ref_chiplib.FakeChipLib(generation=generation, topology=topo,
                                    **kw),
            chiplib.FakeChipLib(generation=generation, topology=topo, **kw))


def as_dicts(chips):
    return [dataclasses.asdict(c) for c in chips]


def rendered(devices):
    return {name: d.get_device() for name, d in devices.items()}


class TestTopologyParity:
    def test_generation_rows_equal_the_reference(self):
        for name, spec in ref_topology.GENERATIONS.items():
            mine = dataclasses.asdict(topology.GENERATIONS[name])
            assert mine.pop("runtime") == "libtpu"
            assert mine == dataclasses.asdict(spec)
            assert topology.runtime_of(name) == "libtpu"
        h100 = topology.GENERATIONS["h100"]
        assert (h100.cores_per_chip, h100.peak_bf16_flops,
                h100.partitionable, h100.runtime) == (1, 989e12, False,
                                                      "cuda")
        assert set(topology.GENERATIONS) == (set(ref_topology.GENERATIONS)
                                             | {"h100"})

    @pytest.mark.parametrize("shape", ["2x2x1", "4x2x1", "2x1x1", "1x1x1",
                                       "4x4x4", "4x2x3", "8x1x1"])
    def test_submeshes_and_contiguity(self, shape):
        for sub in ("1x1x1", "2x1x1", "2x2x1", "2x2x2", "4x4x1"):
            ref = ref_topology.enumerate_submeshes(
                ref_topology.MeshShape.parse(shape),
                ref_topology.MeshShape.parse(sub))
            mine = topology.enumerate_submeshes(
                topology.MeshShape.parse(shape), topology.MeshShape.parse(sub))
            ref = [(str(o), [str(c) for c in m]) for o, m in ref]
            mine = [(str(o), [str(c) for c in m]) for o, m in mine]
            assert mine == ref
            for _, members in ref:
                coords = [ref_topology.Coord.parse(c) for c in members]
                assert topology.is_contiguous_submesh(
                    [topology.Coord.parse(c) for c in members]
                ) == ref_topology.is_contiguous_submesh(coords)
        mesh = topology.MeshShape.parse(shape)
        odd = [topology.Coord(0, 0, 0), topology.Coord(mesh.x - 1, 0, 0)]
        assert topology.is_contiguous_submesh(odd) == \
            ref_topology.is_contiguous_submesh(
                [ref_topology.Coord(c.x, c.y, c.z) for c in odd])

    def test_shapes_and_free_boxes(self):
        for gen in ref_topology.GENERATIONS:
            for n in (1, 2, 4, 8, 16, 64):
                assert str(topology.default_slice_shapes(gen, n)) == \
                    str(ref_topology.default_slice_shapes(gen, n))
        assert str(topology.default_slice_shapes("h100", 8)) == "8x1x1"
        within = ref_topology.MeshShape(4, 4, 2)
        for vol in (1, 2, 4, 6, 8, 16):
            assert topology.box_shapes(
                vol, topology.MeshShape(4, 4, 2)
            ) == ref_topology.box_shapes(vol, within)
        free = {(x, y, z) for x in range(4) for y in range(4)
                for z in range(2) if (x + 2 * y + z) % 5}
        assert topology.largest_free_submesh(
            topology.MeshShape(4, 4, 2), free
        ) == ref_topology.largest_free_submesh(within, free)
        assert sorted(map(sorted, topology.free_components(free))) == \
            sorted(map(sorted, ref_topology.free_components(free)))


class TestFakeChipLibParity:
    @pytest.mark.parametrize("generation,topo,kw", SCENARIOS,
                             ids=SCENARIO_IDS)
    def test_chips_and_devices_equal(self, generation, topo, kw):
        ref, mine = both_fakes(generation, topo, kw)
        ref.init()
        mine.init()
        assert as_dicts(mine.enumerate_chips()) == \
            as_dicts(ref.enumerate_chips())
        classes = {"chip", "tensorcore", "ici"}
        ref_devs = ref.enumerate_all_possible_devices(classes)
        my_devs = mine.enumerate_all_possible_devices(classes)
        assert rendered(my_devs) == rendered(ref_devs)
        assert deviceinfo.counter_sets(my_devs) == \
            ref_deviceinfo.counter_sets(ref_devs)
        assert deviceinfo.chip_uuids(my_devs) == \
            ref_deviceinfo.chip_uuids(ref_devs)
        assert mine.worker_hostnames() == ref.worker_hostnames()
        for d in my_devs.values():
            for u in d.impl.uuids():
                assert deviceinfo.chip_uuid_of_device_uuid(u) == \
                    ref_deviceinfo.chip_uuid_of_device_uuid(u)

    @pytest.mark.parametrize("generation,topo,kw", SCENARIOS[:6],
                             ids=SCENARIO_IDS[:6])
    def test_health_under_faults_equal(self, generation, topo, kw):
        ref, mine = both_fakes(generation, topo, kw)
        n = len(ref.enumerate_chips())

        def view(lib):
            return {u: (h.state, h.reason) for u, h in
                    lib.chip_health().items()}

        script = [
            lambda lib: None,
            lambda lib: lib.wedge_chip(0, "hung runtime"),
            lambda lib: lib.unplug_chip(n - 1),
            lambda lib: lib.set_flap(n // 2, period=2),
            lambda lib: None,
            lambda lib: None,
            lambda lib: lib.restore_chip(0),
            lambda lib: lib.restore_chip(n - 1),
            lambda lib: None,
        ]
        for step in script:
            step(ref)
            step(mine)
            assert view(mine) == view(ref)
            chips_r, health_r = ref.snapshot()
            chips_m, health_m = mine.snapshot()
            assert as_dicts(chips_m) == as_dicts(chips_r)
            assert {u: h.state for u, h in health_m.items()} == \
                {u: h.state for u, h in health_r.items()}
        with pytest.raises(ValueError):
            mine.set_flap(0, period=0)

    def test_side_effect_journals_equal(self):
        ref, mine = both_fakes("v5p", "2x2x1", {})
        for lib in (ref, mine):
            lib.set_sharing_mode(["a", "b"], ref_chiplib.SHARING_TIME_SHARED)
        assert mine.sharing_modes == ref.sharing_modes
        assert mine.create_ici_channel_device(7) == \
            ref.create_ici_channel_device(7)
        assert mine.created_channels == ref.created_channels == [7]


class TestGpuFakeNode:
    """The CUDA side of the mapping on a fake node of 8 H100s."""

    def test_h100_node(self):
        lib = chiplib.FakeChipLib(generation="h100", topology="8x1x1")
        chips = lib.enumerate_chips()
        assert [c.device_paths for c in chips] == \
            [[f"/dev/nvidia{i}"] for i in range(8)]
        for c in chips:
            assert c.uuid.startswith("GPU-")
            assert [len(p) for p in c.uuid[4:].split("-")] == [8, 4, 4, 4, 12]
            assert not c.coords_reliable and c.cores == 1
            assert deviceinfo.chip_uuid_of_device_uuid(c.uuid) == c.uuid
        assert len({c.uuid for c in chips}) == 8
        devs = lib.enumerate_all_possible_devices({"chip", "tensorcore"})
        assert sorted(devs) == [f"tpu-{i}" for i in range(8)]
        assert deviceinfo.counter_sets(devs) == []
        attrs = devs["tpu-0"].get_device()["basic"]["attributes"]
        assert attrs["generation"] == {"string": "h100"}
        assert not any(k.startswith("submesh") for k in attrs)
        assert "consumesCounters" not in devs["tpu-0"].get_device()["basic"]
        assert deviceinfo.partition_profiles("h100") == []


class FakeNvml:
    """What RealChipLib reads, scripted: devices are dicts keyed by the
    handle (index + 100)."""

    def __init__(self, n=2, name="NVIDIA H100 80GB HBM3", events=True):
        self.devices = {
            100 + i: dict(
                uuid=f"GPU-{i:08x}-0000-4000-8000-{i:012x}", name=name,
                total=81559 << 20, minor=i + 3, numa=i % 2,
                bus=f"00000000:{0x19 + i:02X}:00.0", mig=0, ecc=0,
                vbios="96.00.99.00.01")
            for i in range(n)
        }
        self.order = sorted(self.devices)
        self.events = events
        self.queue = []
        self.missing = set()     # method names raising FunctionNotFound
        self.lost = set()        # handles whose uuid NVML no longer finds
        self.calls = []

    def _maybe_missing(self, name):
        self.calls.append(name)
        if name in self.missing:
            raise _nvml.NvmlFunctionNotFound(name)

    def init(self):
        self._maybe_missing("init")

    def shutdown(self):
        self._maybe_missing("shutdown")

    def device_count(self):
        return len(self.order)

    def handle_by_index(self, i):
        return self.order[i]

    def handle_by_uuid(self, uuid):
        for h, d in self.devices.items():
            if d["uuid"] == uuid and h in self.order and h not in self.lost:
                return h
        raise _nvml.NvmlNotFound("nvmlDeviceGetHandleByUUID")

    def uuid(self, h):
        return self.devices[h]["uuid"]

    def name(self, h):
        return self.devices[h]["name"]

    def memory_total(self, h):
        return self.devices[h]["total"]

    def pci_info(self, h):
        d = self.devices[h]
        return _nvml.PciAddress(d["bus"], 0, 0, 0, 0x233010DE)

    def minor_number(self, h):
        return self.devices[h]["minor"]

    def numa_node(self, h):
        self._maybe_missing("numa_node")
        return self.devices[h]["numa"]

    def mig_mode(self, h):
        self._maybe_missing("mig_mode")
        return self.devices[h]["mig"]

    def driver_version(self):
        return "570.124.06"

    def vbios_version(self, h):
        return self.devices[h]["vbios"]

    def ecc_uncorrected(self, h):
        self._maybe_missing("ecc_uncorrected")
        return self.devices[h]["ecc"]

    def event_set_create(self):
        if not self.events:
            raise _nvml.NvmlNotSupported("nvmlEventSetCreate")
        return 7

    def register_events(self, h, types_, event_set):
        assert types_ == _nvml.EVENT_XID_CRITICAL_ERROR and event_set == 7

    def event_set_wait(self, event_set, timeout_ms):
        if not self.queue:
            raise _nvml.NvmlTimeout("nvmlEventSetWait_v2")
        return self.queue.pop(0)

    def event_set_free(self, event_set):
        self.calls.append("event_set_free")


@pytest.fixture
def gpu_host(tmp_path):
    """A dev root holding the fake devices' nodes."""
    (tmp_path / "dev").mkdir()
    for minor in (3, 4):
        (tmp_path / "dev" / f"nvidia{minor}").write_text("")
    return tmp_path


def real_lib(root, nvml, **kw):
    cfg = chiplib.ChipLibConfig(dev_root=str(root),
                                state_dir=str(root / "state"), **kw)
    lib = chiplib.RealChipLib(cfg, nvml=nvml)
    lib.init()
    return lib


class TestRealChipLibOverFakeNvml:
    def test_chip_info_fields(self, gpu_host):
        nv = FakeNvml()
        lib = real_lib(gpu_host, nv, slice_id="node-a")
        chips = lib.enumerate_chips()
        assert [c.index for c in chips] == [0, 1]
        c = chips[1]
        assert c.uuid == nv.devices[101]["uuid"]
        assert c.generation == "h100"
        assert c.device_paths == [str(gpu_host / "dev" / "nvidia4")]
        assert c.hbm_bytes == 81559 << 20
        assert c.pci_address == "00000000:1A:00.0"
        assert c.numa_node == 1
        assert (c.driver_version, c.firmware_version) == \
            ("570.124.06", "96.00.99.00.01")
        assert c.coords_reliable is False and c.cores == 1
        assert str(c.slice_topology) == "2x1x1" and c.slice_id == "node-a"
        dev = deviceinfo.AllocatableDevice(chip=c).get_device()
        assert dev["basic"]["capacity"]["hbm"] == {"value": str(81559 << 20)}
        assert not any(k.startswith("submesh")
                       for k in dev["basic"]["attributes"])

    def test_published_gpu_passes_the_api_servers_schema(self, gpu_host):
        """NVML's version strings are not semver; the published device
        carries them in semver form, and the slice validates with each."""
        from k8s_dra_driver_tpu_torch.kube import FakeKubeClient, ResourceApi
        from k8s_dra_driver_tpu_torch.kube.resourceslice import (
            DriverResources,
            Pool,
            ResourceSliceController,
        )
        from k8s_dra_driver_tpu_torch.kube.schema import validate_for_resource

        lib = real_lib(gpu_host, FakeNvml())
        devices = lib.enumerate_all_possible_devices({"chip"})
        attrs = devices["tpu-0"].get_device()["basic"]["attributes"]
        assert attrs["driverVersion"] == {"version": "570.124.6"}
        assert attrs["firmwareVersion"] == \
            {"version": "150.0.153+96.00.99.00.01"}
        client = FakeKubeClient()
        ctrl = ResourceSliceController(client, "tpu.google.com", scope="n0")
        ctrl.update(DriverResources(pools={"n0": Pool(
            devices=[d.get_device() for d in devices.values()],
            shared_counters=deviceinfo.counter_sets(devices),
            node_name="n0")}))
        ctrl.sync_once()
        (published_slice,) = client.list(
            ResourceApi.discover(client).slices)
        assert len(published_slice["spec"]["devices"]) == 2
        wire = published_slice["spec"]["devices"][0]
        for raw, published in [
                ("1.0.0", "1.0.0"),
                ("1.2.3-rc1", "1.2.3-rc1"),
                ("96.00.99.00.0D", "150.0.153+96.00.99.00.0D"),
                ("96.00.DA.00.0C", "150.0.218+96.00.DA.00.0C"),
                ("570.124.06", "570.124.6"),
                ("535.98", "535.98.0"),
                ("N/A", "0.0.0+N-A"),
                ("", "0.0.0")]:
            attr = deviceinfo._version_attr(raw)
            assert attr == {"version": published}
            wire.get("basic", wire)["attributes"]["firmwareVersion"] = attr
            validate_for_resource("resourceslices", published_slice)

    def test_missing_symbols_read_as_no_signal(self, gpu_host):
        nv = FakeNvml()
        nv.missing = {"numa_node", "mig_mode", "ecc_uncorrected"}
        lib = real_lib(gpu_host, nv)
        assert [c.numa_node for c in lib.enumerate_chips()] == [-1, -1]
        assert {h.state for h in lib.chip_health().values()} == \
            {chiplib.HEALTH_HEALTHY}

    def test_mig_mode_on_raises(self, gpu_host):
        nv = FakeNvml()
        nv.devices[101]["mig"] = _nvml.MIG_ENABLED
        lib = real_lib(gpu_host, nv)
        with pytest.raises(chiplib.MigEnabledError, match="MIG"):
            lib.enumerate_chips()

    def test_unknown_gpu_raises(self, gpu_host):
        lib = real_lib(gpu_host, FakeNvml(name="NVIDIA A100-SXM4-80GB"))
        with pytest.raises(chiplib.UnsupportedGpuError, match="A100"):
            lib.enumerate_chips()

    def test_ecc_advance_reads_degraded(self, gpu_host):
        nv = FakeNvml()
        lib = real_lib(gpu_host, nv)
        first = lib.chip_health()
        assert {h.state for h in first.values()} == {chiplib.HEALTH_HEALTHY}
        nv.devices[100]["ecc"] = 1
        health = lib.chip_health()
        assert health[nv.devices[100]["uuid"]].state == \
            chiplib.HEALTH_DEGRADED
        assert "0 -> 1" in health[nv.devices[100]["uuid"]].reason
        assert health[nv.devices[101]["uuid"]].is_healthy()
        # A count that stays put is no new signal.
        assert lib.chip_health()[nv.devices[100]["uuid"]].is_healthy()

    def test_xid_event_reads_degraded(self, gpu_host):
        nv = FakeNvml()
        lib = real_lib(gpu_host, nv)
        assert lib.wait_device_event(0.01) is False
        nv.queue.append(_nvml.Event(101, _nvml.EVENT_XID_CRITICAL_ERROR, 79))
        assert lib.wait_device_event(0.01) is True
        health = lib.chip_health()
        assert health[nv.devices[101]["uuid"]].state == \
            chiplib.HEALTH_DEGRADED
        assert "Xid 79" in health[nv.devices[101]["uuid"]].reason
        assert lib.chip_health()[nv.devices[101]["uuid"]].is_healthy()
        # An event the poll drains itself counts as well.
        nv.queue.append(_nvml.Event(100, _nvml.EVENT_XID_CRITICAL_ERROR, 48))
        assert not lib.chip_health()[nv.devices[100]["uuid"]].is_healthy()

    @pytest.mark.parametrize("xid", sorted(chiplib.APPLICATION_XIDS))
    def test_application_xid_leaves_the_gpu_healthy(self, gpu_host, xid):
        nv = FakeNvml()
        lib = real_lib(gpu_host, nv)
        nv.queue.append(_nvml.Event(101, _nvml.EVENT_XID_CRITICAL_ERROR, xid))
        assert lib.wait_device_event(0.01) is True
        assert {h.state for h in lib.chip_health().values()} == \
            {chiplib.HEALTH_HEALTHY}
        # One the poll drains itself is skipped as well; a card's own Xid
        # beside it still degrades its GPU.
        nv.queue.append(_nvml.Event(100, _nvml.EVENT_XID_CRITICAL_ERROR, xid))
        nv.queue.append(_nvml.Event(101, _nvml.EVENT_XID_CRITICAL_ERROR, 79))
        health = lib.chip_health()
        assert health[nv.devices[100]["uuid"]].is_healthy()
        assert health[nv.devices[101]["uuid"]].state == \
            chiplib.HEALTH_DEGRADED
        assert "Xid 79" in health[nv.devices[101]["uuid"]].reason

    def test_a_wake_ends_the_event_wait_within_a_slice(self, gpu_host):
        """NVML's event wait blocks for its whole timeout and cannot be
        woken, and ``nvmlShutdown`` waits for it: a plugin whose device
        watch sat in one 30 s wait took 30 s to exit on SIGTERM (found on
        the card). The wait runs in slices and ``device_event`` ends it."""

        class BlockingNvml(FakeNvml):
            def __init__(self):
                super().__init__()
                self.waits = []

            def event_set_wait(self, event_set, timeout_ms):
                self.waits.append(timeout_ms)
                if not self.queue:
                    time.sleep(timeout_ms / 1000)
                return super().event_set_wait(event_set, timeout_ms)

        nv = BlockingNvml()
        lib = real_lib(gpu_host, nv)
        got = []
        waiter = threading.Thread(
            target=lambda: got.append(lib.wait_device_event(30.0)))
        t0 = time.monotonic()
        waiter.start()
        time.sleep(0.1)
        lib.device_event.set()
        waiter.join(timeout=5)
        assert not waiter.is_alive() and got == [True]
        assert time.monotonic() - t0 < 1.0
        assert max(nv.waits) <= 1000 * lib.EVENT_WAIT_SLICE_S
        assert not lib.device_event.is_set()
        # An event still ends the wait, and a quiet wait times out.
        nv.queue.append(_nvml.Event(101, _nvml.EVENT_XID_CRITICAL_ERROR, 79))
        assert lib.wait_device_event(30.0) is True
        assert lib.wait_device_event(0.3) is False

    def test_no_event_support_paces(self, gpu_host):
        nv = FakeNvml(events=False)
        lib = real_lib(gpu_host, nv)
        assert lib.wait_device_event(0.01) is False
        lib.shutdown()
        assert "event_set_free" not in nv.calls

    def test_vanished_gpu_reads_gone(self, gpu_host):
        nv = FakeNvml()
        lib = real_lib(gpu_host, nv)
        u0, u1 = nv.devices[100]["uuid"], nv.devices[101]["uuid"]
        assert {h.state for h in lib.chip_health().values()} == \
            {chiplib.HEALTH_HEALTHY}
        nv.lost.add(100)
        health = lib.chip_health()
        assert health[u0].is_gone() and "NVML" in health[u0].reason
        os.unlink(gpu_host / "dev" / "nvidia4")
        health = lib.chip_health()
        assert health[u1].is_gone() and "nvidia4" in health[u1].reason
        nv.order.remove(101)
        health = lib.chip_health()
        assert health[u1].is_gone()
        assert health[u1].reason == "chip no longer enumerable"

    def test_side_effects(self, gpu_host):
        lib = real_lib(gpu_host, FakeNvml())
        lib.set_sharing_mode(["GPU-x"], chiplib.SHARING_PROCESS_SHARED)
        assert (gpu_host / "state" / "GPU-x.mode").read_text() == \
            chiplib.SHARING_PROCESS_SHARED
        with pytest.raises(NotImplementedError, match="A12"):
            lib.create_ici_channel_device(0)


class TestNvmlBinding:
    def test_struct_layouts(self):
        assert ctypes.sizeof(_nvml.PciInfo) == 68
        assert ctypes.sizeof(_nvml.Memory) == 24
        assert ctypes.sizeof(_nvml.EventData) == 32

    def test_missing_library_raises(self, tmp_path):
        with pytest.raises(_nvml.NvmlLibraryNotFound):
            _nvml.load(str(tmp_path / "libnvidia-ml.so.1"))

    def test_return_codes_are_named(self):
        _nvml.check("f", 0)
        for code, name in _nvml.RETURN_CODES.items():
            with pytest.raises(_nvml.NvmlError) as e:
                _nvml.check("nvmlX", code)
            assert type(e.value).__name__ == f"Nvml{name}"
            assert e.value.code == code and name in str(e.value)
        with pytest.raises(_nvml.NvmlError, match="code 4242"):
            _nvml.check("nvmlX", 4242)
        assert issubclass(_nvml.NvmlTimeout, _nvml.NvmlError)

    def test_calls_map_codes_and_missing_symbols(self):
        def timeout(*args):
            return 10

        def ok(*args):
            return 0

        nv = _nvml.Nvml(types.SimpleNamespace(nvmlEventSetWait_v2=timeout,
                                              nvmlInit_v2=ok))
        nv.init()
        with pytest.raises(_nvml.NvmlTimeout):
            nv.event_set_wait(1, 0)
        with pytest.raises(_nvml.NvmlFunctionNotFound):
            nv.shutdown()


class TestDriverRoot:
    def test_finds_the_nvidia_libraries(self, tmp_path):
        libdir = tmp_path / "usr" / "lib" / "x86_64-linux-gnu"
        libdir.mkdir(parents=True)
        (libdir / "libcuda.so.570.124.06").write_text("")
        (libdir / "libcuda.so.1").symlink_to("libcuda.so.570.124.06")
        root = DriverRoot(root=str(tmp_path), host_root="/host")
        found = root.driver_libraries()
        assert found == {"libcuda.so.1":
                         str(libdir / "libcuda.so.570.124.06")}
        assert root.to_host_path(found["libcuda.so.1"]) == \
            "/host/usr/lib/x86_64-linux-gnu/libcuda.so.570.124.06"
        (libdir / "libnvidia-ml.so.1").write_text("")
        assert set(root.driver_libraries()) == {"libcuda.so.1",
                                                "libnvidia-ml.so.1"}
        (tmp_path / "usr" / "bin").mkdir()
        (tmp_path / "usr" / "bin" / "nvidia-smi").write_text("")
        assert root.find_binary().endswith("usr/bin/nvidia-smi")
        assert root.libtpu_or_none() is None

    def test_link_escape_is_clamped(self, tmp_path):
        libdir = tmp_path / "usr" / "lib64"
        libdir.mkdir(parents=True)
        (libdir / "libcuda.so.1").symlink_to(
            "../../../../../../usr/lib64/libcuda.so.real")
        (libdir / "libcuda.so.real").write_text("")
        root = DriverRoot(root=str(tmp_path))
        assert root.driver_libraries() == {
            "libcuda.so.1": str(libdir / "libcuda.so.real")}
