"""The port's sharing shim (``parallel/shim.py``) against the reference's,
and its CUDA side.

On the reference's envelopes (TPU variables) both shims must make the
same env changes and the same ``SharingRuntime`` / ``SharingUpdate``
decisions. On an envelope naming the "cuda" runtime the port partitions
``CUDA_VISIBLE_DEVICES`` per slot and derives PyTorch's allocator
fraction. Processes that must hold a slot or a lease at the same time
synchronise through pipes, never a sleep.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from k8s_dra_driver_tpu.parallel import shim as ref_shim
from k8s_dra_driver_tpu_torch.parallel import shim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPU_UUIDS = [f"GPU-{i:08x}-0000-4000-8000-{i:012x}" for i in range(4)]


def runtime_fields(rt):
    if rt is None:
        return None
    return {f.name: getattr(rt, f.name) for f in dataclasses.fields(rt)
            if f.name != "_slot_lock"}


def scenarios(shared):
    """(label, env, limits document or None): the reference's envelopes."""
    ps = {"TPU_DRA_SHARING": "process-shared",
          "TPU_DRA_MAX_PROCESSES": "2", "TPU_DRA_SHARED_DIR": shared}
    return [
        ("split chips with a budget", dict(
            ps, TPU_VISIBLE_CHIPS="0,1,2,3",
            TPU_DRA_HBM_LIMIT_BYTES=str(8 << 30),
            TPU_DRA_CHIP_HBM_BYTES=str(16 << 30)), None),
        ("indivisible chips", dict(ps, TPU_VISIBLE_CHIPS="0,1,2"), None),
        ("one process", dict(ps, TPU_DRA_MAX_PROCESSES="1"), None),
        ("operator pinned fraction", dict(
            ps, XLA_PYTHON_CLIENT_MEM_FRACTION="0.1000",
            TPU_DRA_HBM_LIMIT_BYTES=str(12 << 30),
            TPU_DRA_CHIP_HBM_BYTES=str(16 << 30)), None),
        ("driver-injected fraction", dict(
            ps, XLA_PYTHON_CLIENT_MEM_FRACTION="0.7500",
            TPU_DRA_HBM_LIMIT_BYTES=str(12 << 30),
            TPU_DRA_CHIP_HBM_BYTES=str(16 << 30)), None),
        ("limits file at startup", dict(
            ps, TPU_DRA_HBM_LIMIT_BYTES=str(8 << 30),
            TPU_DRA_CHIP_HBM_BYTES=str(16 << 30)),
         {"generation": 3, "tensorcorePercent": 45,
          "hbmLimitBytes": 4 << 30, "chipHbmBytes": 16 << 30}),
        ("time-shared", {"TPU_DRA_SHARING": "time-shared",
                         "TPU_DRA_TIMESHARE_QUANTUM": "3"}, None),
        ("time-shared, bad level", {"TPU_DRA_SHARING": "time-shared",
                                    "TPU_DRA_TIMESHARE_QUANTUM": "9"}, None),
        ("exclusive", {"SOME": "ENV"}, None),
        ("unknown mode", {"TPU_DRA_SHARING": "sometimes"}, None),
    ]


def apply_both(tmp_path, label_index):
    """Run one scenario through each shim in a fresh shared dir of its
    own; returns (reference, port) as (runtime fields, env)."""
    out = []
    for name, mod in (("ref", ref_shim), ("mine", shim)):
        shared = str(tmp_path / name)
        os.makedirs(shared, exist_ok=True)
        _, env, doc = scenarios(shared)[label_index]
        if doc is not None:
            with open(os.path.join(shared, "limits.json"), "w") as f:
                json.dump(doc, f)
        rt = mod.apply_sharing_env(env)
        try:
            again = mod.apply_sharing_env(env)
            fields = runtime_fields(rt)
            out.append((fields, {k: v.replace(shared, "<shared>")
                                 for k, v in env.items()},
                        runtime_fields(again)))
        finally:
            if rt is not None:
                rt.release()
    return out


class TestShimParity:
    @pytest.mark.parametrize("index", range(10), ids=[
        s[0] for s in scenarios("/x")])
    def test_apply_sharing_env_equal(self, tmp_path, index):
        ref, mine = apply_both(tmp_path, index)
        assert mine == ref

    def test_poll_sharing_update_equal(self, tmp_path):
        docs = [
            None,
            {"generation": 2, "tensorcorePercent": 60,
             "hbmLimitBytes": 8 << 30, "chipHbmBytes": 16 << 30},
            {"generation": 2, "tensorcorePercent": 10},
            {"generation": 1, "tensorcorePercent": 30},
            {"generation": 3, "tensorcorePercent": None,
             "hbmLimitBytes": None, "chipHbmBytes": 16 << 30},
            {"generation": "x"},
            {"generation": 5, "hbmLimitBytes": 4 << 30},
        ]
        runs = {}
        for name, mod in (("ref", ref_shim), ("mine", shim)):
            shared = tmp_path / name
            shared.mkdir()
            env = {"TPU_DRA_SHARING": "process-shared",
                   "TPU_DRA_MAX_PROCESSES": "2",
                   "TPU_DRA_SHARED_DIR": str(shared),
                   "TPU_DRA_CHIP_HBM_BYTES": str(16 << 30),
                   "XLA_PYTHON_CLIENT_MEM_FRACTION": "0.2000"}
            rt = mod.apply_sharing_env(env)
            steps = []
            try:
                for doc in docs:
                    if doc is not None:
                        (shared / "limits.json").write_text(json.dumps(doc))
                    upd = mod.poll_sharing_update(env)
                    steps.append((None if upd is None
                                  else dataclasses.asdict(upd),
                                  {k: v.replace(str(shared), "<shared>")
                                   for k, v in env.items()}))
                steps.append(mod.report_usage(0.75, 0.5, env))
                usage = json.loads(
                    (shared / "usage-slot-0.json").read_text())
                steps.append((usage.pop("ts") > 0, usage))
                steps.append(mod.report_usage(0.1, environ={"A": "b"}))
            finally:
                rt.release()
            runs[name] = steps
        assert runs["mine"] == runs["ref"]

    def test_leases_are_no_ops_off_time_share(self):
        for mod in (ref_shim, shim):
            with mod.timeshare_lease({"SOME": "ENV"}):
                pass
            with mod.timeshare_lease({"TPU_DRA_SHARING": "time-shared"}):
                pass


def cuda_env(shared, **extra):
    return {"TPU_DRA_SHARING": "process-shared",
            "TPU_DRA_MAX_PROCESSES": "2", "TPU_DRA_SHARED_DIR": str(shared),
            "TPU_DRA_RUNTIME": "cuda",
            "CUDA_VISIBLE_DEVICES": ",".join(GPU_UUIDS),
            "TPU_DRA_HBM_LIMIT_BYTES": str(36 << 30),
            "TPU_DRA_CHIP_HBM_BYTES": str(80 << 30), **extra}


class TestCudaShim:
    def test_slot_partition_and_fraction(self, tmp_path):
        env0, env1 = cuda_env(tmp_path), cuda_env(tmp_path)
        rt0 = shim.apply_sharing_env(env0)
        rt1 = shim.apply_sharing_env(env1)
        try:
            assert (rt0.slot, rt1.slot) == (0, 1)
            assert env0["CUDA_VISIBLE_DEVICES"] == ",".join(GPU_UUIDS[:2])
            assert env1["CUDA_VISIBLE_DEVICES"] == ",".join(GPU_UUIDS[2:])
            assert rt1.visible_chips == ",".join(GPU_UUIDS[2:])
            assert env0["TPU_DRA_TORCH_MEM_FRACTION"] == "0.4500"
            assert rt0.mem_fraction == 0.45
            assert "XLA_PYTHON_CLIENT_MEM_FRACTION" not in env0
            assert "TPU_VISIBLE_CHIPS" not in env0
            with pytest.raises(shim.SharingRuntimeError):
                shim.apply_sharing_env(cuda_env(tmp_path))
        finally:
            rt0.release()
            rt1.release()

    def test_poll_updates_the_torch_fraction(self, tmp_path):
        env = cuda_env(tmp_path, TPU_DRA_MAX_PROCESSES="1")
        rt = shim.apply_sharing_env(env)
        try:
            (tmp_path / "limits.json").write_text(json.dumps({
                "generation": 2, "tensorcorePercent": 40,
                "hbmLimitBytes": 24 << 30, "chipHbmBytes": 80 << 30}))
            upd = shim.poll_sharing_update(env)
            assert upd.mem_fraction == 0.3
            assert env["TPU_DRA_TORCH_MEM_FRACTION"] == "0.3000"
            assert env["TPU_DRA_ACTIVE_CORE_PERCENTAGE"] == "40"
            assert env["CUDA_MPS_ACTIVE_THREAD_PERCENTAGE"] == "40"
            (tmp_path / "limits.json").write_text(json.dumps({
                "generation": 3, "tensorcorePercent": None,
                "hbmLimitBytes": None, "chipHbmBytes": 80 << 30}))
            assert shim.poll_sharing_update(env).generation == 3
            for key in ("TPU_DRA_TORCH_MEM_FRACTION",
                        "TPU_DRA_ACTIVE_CORE_PERCENTAGE",
                        "CUDA_MPS_ACTIVE_THREAD_PERCENTAGE",
                        "TPU_DRA_HBM_LIMIT_BYTES"):
                assert key not in env
        finally:
            rt.release()

    def test_operator_pins_the_torch_fraction(self, tmp_path):
        env = cuda_env(tmp_path, TPU_DRA_MAX_PROCESSES="1",
                       TPU_DRA_TORCH_MEM_FRACTION="0.2000")
        rt = shim.apply_sharing_env(env)
        try:
            assert rt.mem_fraction == 0.2
            (tmp_path / "limits.json").write_text(json.dumps({
                "generation": 2, "hbmLimitBytes": 24 << 30,
                "chipHbmBytes": 80 << 30}))
            assert shim.poll_sharing_update(env).mem_fraction is None
            assert env["TPU_DRA_TORCH_MEM_FRACTION"] == "0.2000"
        finally:
            rt.release()

    def test_memory_fraction_needs_the_card(self):
        with pytest.raises(ValueError, match="CUDA"):
            shim.apply_memory_fraction("cpu", {})
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                shim.apply_memory_fraction(None, {})

    @pytest.mark.cuda
    def test_memory_fraction_caps_the_allocator(self, tmp_path):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        total = torch.cuda.get_device_properties(0).total_memory
        env = {"TPU_DRA_RUNTIME": "cuda",
               "TPU_DRA_TORCH_MEM_FRACTION": "0.2500"}
        try:
            assert shim.apply_memory_fraction(None, env) == 0.25
            torch.cuda.empty_cache()
            room = int(0.25 * total) - torch.cuda.memory_reserved()
            ok = torch.empty(room - (64 << 20), dtype=torch.uint8,
                             device="cuda")
            del ok
            torch.cuda.empty_cache()
            with pytest.raises(torch.OutOfMemoryError, match="allowed"):
                torch.empty(room + (64 << 20), dtype=torch.uint8,
                            device="cuda")
        finally:
            shim.apply_memory_fraction(None, {})


HOLD_SLOT = """
import json, os, sys
from k8s_dra_driver_tpu_torch.parallel.shim import (
    SharingRuntimeError, apply_sharing_env)
try:
    rt = apply_sharing_env()
except SharingRuntimeError as e:
    print(json.dumps({"refused": str(e)}), flush=True)
    sys.exit(0)
print(json.dumps({"slot": rt.slot, "visible": os.environ.get(sys.argv[1]),
                  "fraction": os.environ.get(sys.argv[2])}), flush=True)
sys.stdin.readline()   # hold the slot until the parent says so
"""


def start(code, env, *args):
    return subprocess.Popen(
        [sys.executable, "-c", code, *args], env={**os.environ, **env},
        cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


class TestProcesses:
    @pytest.mark.parametrize("runtime", ["libtpu", "cuda"])
    def test_two_processes_get_disjoint_slots_and_a_third_is_refused(
            self, tmp_path, runtime):
        """Two processes hold their slots while a third asks: each holder
        reports its slot on a pipe and keeps it until its stdin closes."""
        if runtime == "cuda":
            env = cuda_env(tmp_path)
            names = ("CUDA_VISIBLE_DEVICES", "TPU_DRA_TORCH_MEM_FRACTION")
            chips = GPU_UUIDS
        else:
            env = {"TPU_DRA_SHARING": "process-shared",
                   "TPU_DRA_MAX_PROCESSES": "2",
                   "TPU_DRA_SHARED_DIR": str(tmp_path),
                   "TPU_VISIBLE_CHIPS": "0,1,2,3",
                   "TPU_DRA_HBM_LIMIT_BYTES": str(8 << 30),
                   "TPU_DRA_CHIP_HBM_BYTES": str(16 << 30)}
            names = ("TPU_VISIBLE_CHIPS", "XLA_PYTHON_CLIENT_MEM_FRACTION")
            chips = ["0", "1", "2", "3"]
        holders = [start(HOLD_SLOT, env, *names) for _ in range(2)]
        try:
            outs = [json.loads(p.stdout.readline()) for p in holders]
            third = start(HOLD_SLOT, env, *names)
            refused, err = third.communicate(timeout=120)
            assert third.returncode == 0, err
            assert "busy" in json.loads(refused)["refused"]
        finally:
            for p in holders:
                p.stdin.close()
            for p in holders:
                p.wait(timeout=120)
        for p in holders:
            assert p.returncode == 0, p.stderr.read()
        by_slot = {o["slot"]: o for o in outs}
        assert sorted(by_slot) == [0, 1]
        assert by_slot[0]["visible"] == ",".join(chips[:2])
        assert by_slot[1]["visible"] == ",".join(chips[2:])
        want = "0.4500" if runtime == "cuda" else "0.5000"
        assert {o["fraction"] for o in outs} == {want}

    def test_time_share_leases_never_overlap(self, tmp_path):
        """Two processes take the lease 20 times each, working inside it
        until a monotonic deadline; both start together off one pipe."""
        code = """
import json, sys, time
from k8s_dra_driver_tpu_torch.parallel.shim import timeshare_lease
sys.stdin.readline()
spans = []
for _ in range(20):
    with timeshare_lease():
        start = time.clock_gettime(time.CLOCK_MONOTONIC)
        while time.clock_gettime(time.CLOCK_MONOTONIC) < start + 0.002:
            pass
        spans.append((start, time.clock_gettime(time.CLOCK_MONOTONIC)))
print(json.dumps(spans), flush=True)
"""
        env = {"TPU_DRA_SHARING": "time-shared",
               "TPU_DRA_TIMESHARE_QUANTUM": "1",
               "TPU_DRA_SHARED_DIR": str(tmp_path),
               "TPU_DRA_RUNTIME": "cuda",
               "TPU_DRA_CHIP_UUIDS": ",".join(GPU_UUIDS[:2])}
        procs = [start(code, env) for _ in range(2)]
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        spans = []
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            spans.append(json.loads(out))
        assert [len(s) for s in spans] == [20, 20]
        merged = sorted((a, b, i) for i, s in enumerate(spans)
                        for a, b in s)
        for (a0, b0, _), (a1, _, _) in zip(merged, merged[1:]):
            assert b0 <= a1, "leases overlap"
        assert time.clock_gettime(time.CLOCK_MONOTONIC) >= merged[-1][1]
