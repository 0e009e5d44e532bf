"""The port's allocator at pod-slice scale: the twins of the reference's
``tests/test_allocator_scale.py`` on ``k8s_dra_driver_tpu_torch.kube``,
and the incremental index through ResourceSlice deltas on a pool of
H100 nodes with MIG devices.

The reference's nine cases run unchanged on the port's modules: a
64-chip v5p 4x4x4 slice over 16 hosts (gang fills, counter sets at
scale, the metrics, the steady-state CEL cache, batch solving, the CEL
memo and, marked slow as in the reference, the seeded parity oracle).
``TestMigChurn`` replays a seeded churn schedule over 8 nodes of 8 H100s,
some GPUs in MIG mode, through an incremental and a from-scratch
allocator: allocations of whole GPUs and of MIG devices, releases,
health flips and MIG layout changes republished as slice deltas. After
every step both must agree, and the incremental side must have rebuilt
only the pools a delta touched.
"""

import random
import time

import pytest

from k8s_dra_driver_tpu_torch.kube import NODES, FakeKubeClient
from k8s_dra_driver_tpu_torch.kube.allocator import (
    AllocationError,
    ReferenceAllocator,
)
from k8s_dra_driver_tpu_torch.kube.resourceslice import (
    DriverResources,
    Pool,
    ResourceSliceController,
)
from k8s_dra_driver_tpu_torch.tpulib import FakeChipLib

DRIVER = "tpu.google.com"
HOSTS = 16
TOPOLOGY = "4x4x4"  # 64 chips, 4 per host


def publish_cluster(client):
    from k8s_dra_driver_tpu_torch.tpulib.deviceinfo import counter_sets

    for h in range(HOSTS):
        node = f"node-{h:02d}"
        client.create(NODES, {"metadata": {"name": node, "uid": f"u-{h}"}})
        lib = FakeChipLib(
            generation="v5p",
            topology=TOPOLOGY,
            host_id=h,
            hosts_per_slice=HOSTS,
            slice_id="big-slice",
        )
        devices = []
        allocatable = lib.enumerate_all_possible_devices(
            {"chip", "tensorcore"}
        )
        for name, dev in sorted(allocatable.items()):
            devices.append(dev.get_device())
        ctrl = ResourceSliceController(
            client,
            DRIVER,
            scope=node,
            owner={"kind": "Node", "name": node, "uid": f"u-{h}"},
        )
        ctrl.update(DriverResources(pools={
            node: Pool(
                devices=devices,
                shared_counters=counter_sets(allocatable),
                node_name=node,
            )
        }))
        ctrl.sync_once()


def gang_claim(uid, n, match=None):
    reqs = [
        {"name": f"chip-{i}", "deviceClassName": "tpu.google.com"}
        for i in range(n)
    ]
    constraints = (
        [{"requests": [r["name"] for r in reqs], "matchAttribute": match}]
        if match else []
    )
    return {
        "metadata": {"name": f"claim-{uid}", "namespace": "scale",
                     "uid": uid},
        "spec": {"devices": {"requests": reqs,
                             "constraints": constraints}},
    }


class TestAllocatorScale:
    def test_fill_the_slice_with_2x2_gangs(self):
        """16 gang claims of 2x2 tiles exactly fill the 64-chip slice;
        the 17th must fail. Whole run bounded to keep backtracking
        honest."""
        client = FakeKubeClient()
        publish_cluster(client)
        alloc = ReferenceAllocator(client, driver_name=DRIVER)

        t0 = time.monotonic()
        granted = []
        for i in range(16):
            claim = gang_claim(
                f"uid-{i:02d}", 4, match="tpu.google.com/submesh2x2Id"
            )
            alloc.allocate(claim)
            results = claim["status"]["allocation"]["devices"]["results"]
            assert len(results) == 4
            granted.append({(r["pool"], r["device"]) for r in results})
        elapsed = time.monotonic() - t0
        assert elapsed < 60, f"allocator pathologically slow: {elapsed:.1f}s"

        # All 64 chips distinct across the 16 gangs.
        all_devs = set().union(*granted)
        assert len(all_devs) == 64

        with pytest.raises(AllocationError):
            alloc.allocate(gang_claim(
                "uid-overflow", 4, match="tpu.google.com/submesh2x2Id"
            ))

    def test_4x4_submesh_gang(self):
        """BASELINE.md's headline gang: a contiguous 4x4 v5p sub-mesh (16
        chips) via the submesh4x4Id tile attribute, allocated whole from
        the 4x4x4 slice; four of them drain the slice."""
        client = FakeKubeClient()
        publish_cluster(client)
        alloc = ReferenceAllocator(client, driver_name=DRIVER)
        granted = []
        t0 = time.monotonic()
        for i in range(4):
            claim = gang_claim(
                f"uid-4x4-{i}", 16, match="tpu.google.com/submesh4x4Id"
            )
            alloc.allocate(claim)
            results = claim["status"]["allocation"]["devices"]["results"]
            assert len(results) == 16
            granted.append({(r["pool"], r["device"]) for r in results})
        elapsed = time.monotonic() - t0
        assert elapsed < 60, f"allocator pathologically slow: {elapsed:.1f}s"
        assert len(set().union(*granted)) == 64
        with pytest.raises(AllocationError):
            alloc.allocate(gang_claim(
                "uid-4x4-over", 16, match="tpu.google.com/submesh4x4Id"
            ))

    def test_core_counters_hold_at_scale(self):
        """Claiming every chip whole leaves no core partition grantable
        anywhere in the 16-pool inventory (counter sets at scale)."""
        client = FakeKubeClient()
        publish_cluster(client)
        alloc = ReferenceAllocator(client, driver_name=DRIVER)
        for i in range(8):
            alloc.allocate(gang_claim(f"uid-w{i}", 8))
        core_claim = {
            "metadata": {"name": "core", "namespace": "scale",
                         "uid": "uid-core"},
            "spec": {"devices": {"requests": [{
                "name": "core",
                "deviceClassName": "tensorcore.tpu.google.com",
            }]}},
        }
        with pytest.raises(AllocationError):
            alloc.allocate(core_claim)

    def test_release_reopens_capacity(self):
        client = FakeKubeClient()
        publish_cluster(client)
        alloc = ReferenceAllocator(client, driver_name=DRIVER)
        for i in range(16):
            alloc.allocate(gang_claim(f"uid-{i:02d}", 4))
        with_hole = gang_claim("uid-again", 4)
        with pytest.raises(AllocationError):
            alloc.allocate(with_hole)
        alloc.deallocate("uid-07")
        alloc.allocate(with_hole)
        assert len(
            with_hole["status"]["allocation"]["devices"]["results"]
        ) == 4

    def test_attempt_and_backtrack_metrics(self):
        """A registry-attached allocator (the tools/sim_check_allocation.py
        wiring) reports solve outcomes and solver thrash on /metrics."""
        from k8s_dra_driver_tpu_torch.utils.metrics import Registry

        client = FakeKubeClient()
        publish_cluster(client)
        registry = Registry()
        alloc = ReferenceAllocator(client, driver_name=DRIVER,
                                   registry=registry)
        for i in range(16):
            alloc.allocate(gang_claim(f"uid-{i:02d}", 4))
        with pytest.raises(AllocationError):
            alloc.allocate(gang_claim("uid-full", 4))
        text = registry.render()
        assert 'tpu_dra_allocation_attempts_total{result="ok"} 16' in text
        assert 'tpu_dra_allocation_attempts_total{result="error"} 1' in text
        assert "tpu_dra_allocation_backtracks_total" in text

        # Backtrack accounting: a 2-chip gang restricted to two opposite
        # corners of the mesh forces the solver to try and undo the
        # non-contiguous pair before giving up.
        from k8s_dra_driver_tpu_torch.kube.allocator import Selector

        frag = ReferenceAllocator(client, driver_name=DRIVER,
                                  registry=Registry())
        claim = {
            "metadata": {"name": "frag", "namespace": "scale",
                         "uid": "uid-frag"},
            "spec": {"devices": {"requests": [{
                "name": "pair", "deviceClassName": "tpu.google.com",
                "count": 2,
            }]}},
        }
        corners = Selector("coord", "in", ["0,0,0", "3,3,3"])
        with pytest.raises(AllocationError):
            frag.allocate(claim, selectors={"pair": [corners]})
        assert frag._m_backtracks.value() > 0

    def test_steady_state_solve_reuses_cached_filters(self, monkeypatch):
        """With no ResourceSlice delta between solves, the SECOND solve
        of the same request shape runs zero CEL evaluations — the
        incremental index's whole point. A delta then re-evaluates only
        the changed pool's devices."""
        import k8s_dra_driver_tpu_torch.kube.allocator as allocator_mod

        calls = {"n": 0}
        real = allocator_mod.cel_evaluate_detailed

        def counting(*args, **kwargs):
            calls["n"] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(
            allocator_mod, "cel_evaluate_detailed", counting
        )
        client = FakeKubeClient()
        publish_cluster(client)
        class_expr = "device.attributes['tpu.google.com'].type == 'chip'"
        alloc = ReferenceAllocator(
            client, driver_name=DRIVER,
            device_classes={DRIVER: [class_expr]},
        )
        alloc.allocate(gang_claim("uid-warm", 4))
        warm_calls = calls["n"]
        assert warm_calls > 0
        gen = alloc.index.generation
        alloc.allocate(gang_claim("uid-steady", 4))
        assert calls["n"] == warm_calls, (
            "a steady-state solve re-ran CEL despite no slice delta"
        )
        assert alloc.recent_decisions()[-1]["celEvaluations"] == 0
        assert alloc.index.generation == gen  # no delta observed
        # One slice delta (device attribute change via republish):
        # exactly the changed pool re-filters — bounded by its device
        # count, nowhere near the fleet's.
        api = alloc.api
        slices = [
            s for s in client.list(api.slices)
            if s["spec"]["pool"]["name"] == "node-03"
        ]
        assert slices
        target = slices[0]
        dev0 = target["spec"]["devices"][0]
        attrs = dev0.setdefault("basic", dev0.get("basic", {})).setdefault(
            "attributes", {}
        )
        attrs["healthy"] = {"bool": False}
        client.update(api.slices, target)
        alloc.allocate(gang_claim("uid-after-delta", 4))
        assert alloc.index.generation == gen + 1
        pool_devices = sum(
            1 for d in alloc.index.devices if d["pool"] == "node-03"
        )
        delta_calls = calls["n"] - warm_calls
        assert 0 < delta_calls <= pool_devices, (
            f"{delta_calls} CEL evaluations after a one-pool delta "
            f"(pool has {pool_devices} devices)"
        )

    @pytest.mark.slow  # O(claims) from-scratch re-solves; dominates tier-1
    def test_parity_oracle_incremental_vs_from_scratch(self):
        """The regression oracle for the incremental solver: one seeded
        churn schedule (allocations, releases, health-flip slice deltas,
        healthy-only solves) replayed through an incremental and a
        from-scratch allocator over the same cluster. After EVERY step
        the two must agree: same satisfiability, same granted device
        sets, same terminal reason and funnel shape on unsat."""
        client = FakeKubeClient()
        publish_cluster(client)
        inc = ReferenceAllocator(client, driver_name=DRIVER)
        scratch = ReferenceAllocator(
            client, driver_name=DRIVER, incremental=False,
        )
        api = inc.api
        rng = random.Random(20260804)
        live: list[str] = []
        flipped = False
        serial = 0
        unsats = 0
        for step in range(70):
            r = rng.random()
            if r < 0.12:
                # Slice delta: toggle one chip's healthy attribute on a
                # random pool (the republish shape of a health flip).
                pool = f"node-{rng.randrange(HOSTS):02d}"
                target = next(
                    s for s in client.list(api.slices)
                    if s["spec"]["pool"]["name"] == pool
                )
                dev = rng.choice(target["spec"]["devices"])
                attrs = dev.setdefault("basic", {}).setdefault(
                    "attributes", {}
                )
                old = attrs.get("healthy", {}).get("bool", True)
                attrs["healthy"] = {"bool": not old}
                client.update(api.slices, target)
                flipped = True
                continue
            if r < 0.45 and live:
                uid = live.pop(rng.randrange(len(live)))
                inc.deallocate(uid)
                scratch.deallocate(uid)
                continue
            serial += 1
            uid = f"uid-churn-{serial:03d}"
            count = rng.choice((1, 2, 4, 4, 8, 16, 16, 32))
            healthy_only = rng.random() < 0.3
            outcomes = []
            for alloc in (inc, scratch):
                claim = gang_claim(uid, count)
                try:
                    alloc.allocate(claim, require_healthy=healthy_only)
                    results = frozenset(
                        (res["pool"], res["device"]) for res in
                        claim["status"]["allocation"]["devices"]["results"]
                    )
                    outcomes.append(("ok", results, None))
                except AllocationError as e:
                    rec = alloc.recent_decisions()[-1]
                    funnel_shape = tuple(sorted(
                        (f["request"], tuple(sorted(f["rejected"].items())),
                         f["entering"], f["survivors"], f["wanted"])
                        for f in rec["funnels"]
                    ))
                    outcomes.append((e.reason, None, funnel_shape))
            assert outcomes[0] == outcomes[1], (
                f"step {step} (uid {uid}, count {count}, "
                f"healthy_only {healthy_only}): incremental "
                f"{outcomes[0]} != from-scratch {outcomes[1]}"
            )
            if outcomes[0][0] == "ok":
                live.append(uid)
            else:
                unsats += 1
        # The schedule must actually have exercised the interesting
        # paths, or the oracle proves nothing.
        assert flipped, "schedule produced no slice delta"
        assert unsats > 0, "schedule produced no unsat solves"
        assert inc.index.generation > 0
        # And the incremental side must have been incremental: it never
        # force-rebuilds, so its pool rebuilds stay far below the
        # from-scratch side's (which rebuilds every pool every solve).
        assert inc.index.rebuilds < scratch.index.rebuilds / 4

    def test_allocate_batch_shares_one_snapshot_and_orders_by_size(self):
        """Batch solving: the queue solves most-constrained-first over
        ONE inventory snapshot, so a big gang is not shredded by the
        singles ahead of it in FIFO order; results return in input
        order with per-claim funnels intact."""
        client = FakeKubeClient()
        publish_cluster(client)

        # FIFO baseline: 32 singles scattered first make the 16-gang
        # (which needs a contiguous 4x4x1 / 2x2x4 box) harder than it
        # has to be; the batch order solves it first instead.
        alloc = ReferenceAllocator(client, driver_name=DRIVER)
        claims = [gang_claim(f"uid-s{i:02d}", 1) for i in range(32)]
        claims.append(gang_claim("uid-gang16", 16))
        claims.append(gang_claim("uid-gang8", 8))
        probes_before = alloc.index.probes
        decisions_before = len(alloc.recent_decisions())
        outcomes = alloc.allocate_batch(claims)
        # One snapshot = one signature probe for the whole batch.
        assert alloc.index.probes == probes_before + 1
        # Input order preserved; every claim produced a decision record.
        assert [c["metadata"]["uid"] for c, _ in outcomes] \
            == [c["metadata"]["uid"] for c in claims]
        assert len(alloc.recent_decisions()) - decisions_before \
            == len(claims)
        # The big gangs solved (they went first); their devices are
        # contiguous boxes despite 32 singles in the same batch.
        by_uid = {c["metadata"]["uid"]: err for c, err in outcomes}
        assert by_uid["uid-gang16"] is None
        assert by_uid["uid-gang8"] is None
        assert sum(1 for err in by_uid.values() if err is None) \
            == len(claims)  # 32 + 16 + 8 = 56 <= 64 chips: all fit
        # Per-claim funnels: each record names its own claim.
        recent = alloc.recent_decisions()[decisions_before:]
        assert {r["claim"]["uid"] for r in recent} \
            == {c["metadata"]["uid"] for c in claims}

    def test_cel_memo_keeps_evaluations_linear(self, monkeypatch):
        """The per-solve (expression, device) memo: a 4-chip gang over
        the 192-device inventory with a one-expression DeviceClass must
        evaluate CEL at most once per (expression, device) — before the
        memo, every backtrack probe re-entered candidates() and re-ran
        the expression against every device."""
        import k8s_dra_driver_tpu_torch.kube.allocator as allocator_mod

        calls = {"n": 0}
        real = allocator_mod.cel_evaluate_detailed

        def counting(*args, **kwargs):
            calls["n"] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(
            allocator_mod, "cel_evaluate_detailed", counting
        )
        client = FakeKubeClient()
        publish_cluster(client)
        class_expr = "device.attributes['tpu.google.com'].type == 'chip'"
        alloc = ReferenceAllocator(
            client, driver_name=DRIVER,
            device_classes={DRIVER: [class_expr]},
        )
        claim = gang_claim(
            "uid-memo", 4, match="tpu.google.com/submesh2x2Id"
        )
        alloc.allocate(claim)
        n_devices = 64 + 128  # chips + core partitions over 16 hosts
        assert calls["n"] <= n_devices, (
            f"{calls['n']} CEL evaluations for {n_devices} devices: "
            "the per-solve memo is not being consulted"
        )
        # The decision record exposes the same number, so memo
        # regressions are visible from /debug/allocations too.
        rec = alloc.recent_decisions()[-1]
        assert rec["celEvaluations"] == calls["n"]
        assert rec["celEvaluations"] <= n_devices


# The MIG layouts a GPU of the churn pool takes (None: not in MIG mode;
# EVERY: every placement of every profile published, as a driver that
# created instances on demand would, so that overlapping placements
# compete for the memory-slice counters).
EVERY = "every"
MIG_LAYOUTS = [
    None,
    EVERY,
    [("7g.80gb", 0)],
    [("3g.40gb", 0), ("3g.40gb", 4)],
    [("3g.40gb", 0), ("2g.20gb", 4), ("1g.10gb", 6)],
    [("1g.10gb", i) for i in range(7)],
    [("4g.40gb", 0), ("1g.20gb", 4), ("1g.20gb", 6)],
]
H100_NODES = 8
H100_GPUS = 8
MIG_PROFILE_NAMES = ("1g.10gb", "1g.20gb", "2g.20gb", "3g.40gb",
                     "4g.40gb", "7g.80gb")


class H100Pools:
    """``H100_NODES`` nodes of ``H100_GPUS`` H100s, each GPU in one of
    ``MIG_LAYOUTS``; a node's pool is republished by its own controller
    whenever its layout changes (a ResourceSlice delta)."""

    def __init__(self, client, rng):
        from k8s_dra_driver_tpu_torch.kube import NODES as PORT_NODES

        self.client = client
        self.layouts = {}
        self.ctrls = {}
        for h in range(H100_NODES):
            node = f"gpu-node-{h}"
            client.create(PORT_NODES, {"metadata": {"name": node,
                                                    "uid": f"g-{h}"}})
            self.layouts[node] = {g: rng.choice(MIG_LAYOUTS)
                                  for g in range(H100_GPUS)}
            self.ctrls[node] = ResourceSliceController(
                client, DRIVER, scope=node,
                owner={"kind": "Node", "name": node, "uid": f"g-{h}"})
            self.publish(node)

    def publish(self, node):
        from k8s_dra_driver_tpu_torch.tpulib.deviceinfo import (
            AllocatableDevice,
            MigDeviceInfo,
            counter_sets,
            partition_profiles,
        )

        layouts = self.layouts[node]
        lib = FakeChipLib(
            generation="h100", topology=f"{H100_GPUS}x1x1", slice_id=node,
            mig={g: layout for g, layout in layouts.items()
                 if layout and layout != EVERY})
        allocatable = lib.enumerate_all_possible_devices(
            {"chip", "tensorcore"})
        for chip in lib.enumerate_chips():
            if layouts[chip.index] != EVERY:
                continue
            del allocatable[chip.canonical_name()]
            for p in partition_profiles("h100"):
                for start in p.slice_placements:
                    d = MigDeviceInfo(
                        parent=chip, core_index=start, profile=p,
                        mig_uuid=f"MIG-{node}-{chip.index}-{p.name}-{start}",
                        memory_bytes=chip.hbm_bytes * p.memory_slices // 8,
                        gi_id=0)
                    allocatable[d.canonical_name()] = AllocatableDevice(
                        tensorcore=d)
        self.ctrls[node].update(DriverResources(pools={node: Pool(
            devices=[d.get_device() for _, d in sorted(allocatable.items())],
            shared_counters=counter_sets(allocatable), node_name=node)}))
        self.ctrls[node].sync_once()


def slices_of(name):
    """(gpu, memory slice) for each slice a granted device holds: all 8
    of a whole GPU, a MIG device's placement from its name
    (``tpu-<gpu>-mig-<profile id>-<start>-<size>``)."""
    parts = name.split("-")
    gpu = int(parts[1])
    if len(parts) == 2:
        return [(gpu, i) for i in range(8)]
    start, size = int(parts[4]), int(parts[5])
    return [(gpu, i) for i in range(start, start + size)]


def mig_claim(uid, profile, count):
    expr = ("device.attributes['tpu.google.com'].profile == "
            f"'{profile}'")
    return {
        "metadata": {"name": f"claim-{uid}", "namespace": "scale",
                     "uid": uid},
        "spec": {"devices": {"requests": [{
            "name": "mig", "deviceClassName": "tensorcore.tpu.google.com",
            "count": count,
            "selectors": [{"cel": {"expression": expr}}]}],
            "constraints": []}},
    }


class TestMigChurn:
    def test_incremental_index_through_deltas_on_mig_pools(self):
        """A seeded churn schedule over the H100 pools through an
        incremental and a from-scratch allocator: whole-GPU gangs and
        MIG-device claims (their memory-slice counters, which decide
        between overlapping placements where a GPU publishes every
        one), releases, and
        two kinds of slice delta: a health flip and a GPU's MIG layout
        changed and republished. After every step the two agree on
        satisfiability, granted devices, terminal reason and funnel; a
        solve after deltas rebuilds exactly the pools they touched."""
        from test_cel import load_device_classes

        client = FakeKubeClient()
        rng = random.Random(20261018)
        pools = H100Pools(client, rng)
        classes = load_device_classes()
        inc = ReferenceAllocator(client, driver_name=DRIVER,
                                 device_classes=classes)
        scratch = ReferenceAllocator(client, driver_name=DRIVER,
                                     device_classes=classes,
                                     incremental=False)
        api = inc.api
        live: dict[str, set] = {}
        dirty: set[str] = set()
        first_solved = False
        serial = 0
        seen = {"flip": 0, "layout": 0, "mig_ok": 0, "gpu_ok": 0,
                "unsat": 0, "release": 0}
        for step in range(90):
            r = rng.random()
            if r < 0.08:
                # Health flip on one device of a random pool.
                node = f"gpu-node-{rng.randrange(H100_NODES)}"
                target = next(s for s in client.list(api.slices)
                              if s["spec"]["pool"]["name"] == node)
                dev = rng.choice(target["spec"]["devices"])
                attrs = dev.setdefault("basic", {}).setdefault(
                    "attributes", {})
                old = attrs.get("healthy", {}).get("bool", True)
                attrs["healthy"] = {"bool": not old}
                client.update(api.slices, target)
                dirty.add(node)
                seen["flip"] += 1
                continue
            if r < 0.2:
                # A GPU no live claim holds changes its MIG layout.
                node = f"gpu-node-{rng.randrange(H100_NODES)}"
                gpu = rng.randrange(H100_GPUS)
                busy = any(
                    p == node and (d == f"tpu-{gpu}"
                                   or d.startswith(f"tpu-{gpu}-mig-"))
                    for held in live.values() for p, d in held)
                if busy:
                    continue
                pools.layouts[node][gpu] = rng.choice(
                    [layout for layout in MIG_LAYOUTS
                     if layout != pools.layouts[node][gpu]])
                pools.publish(node)
                dirty.add(node)
                seen["layout"] += 1
                continue
            if r < 0.45 and live:
                uid = rng.choice(sorted(live))
                del live[uid]
                inc.deallocate(uid)
                scratch.deallocate(uid)
                seen["release"] += 1
                continue
            serial += 1
            uid = f"uid-mig-{serial:03d}"
            if rng.random() < 0.55:
                kind = "mig_ok"
                profile = rng.choice(MIG_PROFILE_NAMES)
                count = rng.choice((1, 1, 2, 3))
            else:
                kind = "gpu_ok"
                count = rng.choice((1, 2, 4, 8, 16))
            healthy_only = rng.random() < 0.3
            outcomes = []
            rebuilds = inc.index.rebuilds
            for alloc in (inc, scratch):
                claim = (mig_claim(uid, profile, count) if kind == "mig_ok"
                         else gang_claim(uid, count))
                try:
                    alloc.allocate(claim, require_healthy=healthy_only)
                    results = frozenset(
                        (res["pool"], res["device"]) for res in
                        claim["status"]["allocation"]["devices"]["results"]
                    )
                    outcomes.append(("ok", results, None))
                except AllocationError as e:
                    rec = alloc.recent_decisions()[-1]
                    funnel_shape = tuple(sorted(
                        (f["request"], tuple(sorted(f["rejected"].items())),
                         f["entering"], f["survivors"], f["wanted"])
                        for f in rec["funnels"]
                    ))
                    outcomes.append((e.reason, None, funnel_shape))
            assert outcomes[0] == outcomes[1], (
                f"step {step} (uid {uid}): incremental {outcomes[0]} != "
                f"from-scratch {outcomes[1]}")
            # The first solve builds every pool; each later one exactly
            # the pools the deltas since the last solve touched.
            assert inc.index.rebuilds - rebuilds == (
                len(dirty) if first_solved else H100_NODES), (step, dirty)
            first_solved = True
            dirty.clear()
            if outcomes[0][0] == "ok":
                live[uid] = outcomes[0][1]
                seen[kind] += 1
            else:
                seen["unsat"] += 1
            # No memory slice (nor whole GPU) is held twice.
            held = [(pool, gpu_slice) for h in live.values()
                    for pool, name in h for gpu_slice in slices_of(name)]
            assert len(held) == len(set(held)), step
        assert all(seen[k] > 0 for k in seen), seen
        assert inc.index.rebuilds < scratch.index.rebuilds / 4
