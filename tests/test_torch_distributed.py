"""The port's distributed bootstrap (``parallel/distributed.py``) against
the JAX package's: the twins of ``tests/test_distributed_e2e.py``'s launch
env cases and of its two-process bootstrap.

Both packages' node plugins prepare the same gang claim with an ICI
channel; the claim spec's env must be equal, and so must what each
package's ``coordinator_from_env`` reads from it. Then two REAL
subprocesses take the env that the PORT's prepare injected, call the
port's ``initialize_distributed()``, form one two-process ``gloo`` group
(they see no CUDA device) and ``all_reduce`` a tensor.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

from test_torch_kube import PORT, REF, SIDES

DRIVER = "tpu.google.com"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("TPU_DRA_COORDINATOR", "TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID",
            "TPU_DRA_COORDINATOR_PORT")
WORKER_TIMEOUT_S = 30

WORKER_SRC = """
import torch
import torch.distributed as dist

from k8s_dra_driver_tpu_torch.parallel.distributed import (
    initialize_distributed,
)

assert initialize_distributed(), "driver env did not trigger distributed init"
assert dist.get_backend() == "gloo", dist.get_backend()
pid = dist.get_rank()
local = torch.full((4,), float(pid + 1))
dist.all_reduce(local)
print("RESULT", dist.get_world_size(), float(local.sum()), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _make_claim(uid: str, devices: list[str]) -> dict:
    results = [
        {"request": "req-0", "driver": DRIVER, "pool": "node", "device": d}
        for d in devices
    ]
    return {
        "metadata": {"name": "gang", "namespace": "default", "uid": uid},
        "status": {"allocation": {"devices": {
            "results": results,
            "config": [{
                "source": "FromClaim", "requests": [],
                "opaque": {"driver": DRIVER, "parameters": {
                    "apiVersion": "tpu.google.com/v1alpha1",
                    "kind": "IciChannelConfig"}},
            }],
        }}},
    }


def _prepare_host_env(side, root, host_id: int, hostnames: list[str],
                      devices=None) -> dict:
    """Run one node plugin's prepare on ``side`` and return the claim
    spec's env."""
    lib = side("tpulib").FakeChipLib(
        generation="v5e", topology="2x2x1", host_id=host_id,
        hosts_per_slice=2, chips_per_host=2, hostnames=hostnames,
        slice_id="v5e-2x2x1-gang")
    host_dir = root / f"host{host_id}"
    # An empty driver root: the reference would also find a libtpu wheel
    # in this host's Python environment, the port does not look.
    (host_dir / "driver").mkdir(parents=True, exist_ok=True)
    state = side("plugin.device_state").DeviceState(
        chiplib=lib,
        cdi=side("cdi").CDIHandler(
            str(host_dir / "cdi"), driver_root=str(host_dir / "driver"),
            driver_root_ctr_path=str(host_dir / "driver")),
        checkpoint=side("plugin.checkpoint").CheckpointManager(
            str(host_dir / "checkpoint.json")),
        driver_name=DRIVER, pool_name="node",
        state_dir=str(host_dir / "state"))
    uid = f"uid-gang-{host_id}"
    state.prepare(_make_claim(
        uid, devices or ["tpu-0", "tpu-1", "ici-channel-3"]))
    spec = json.loads((host_dir / "cdi" /
                       f"k8s.tpu.google.com-claim_{uid}.json").read_text())
    env: dict[str, str] = {}
    edit_sets = [dev.get("containerEdits", {}) for dev in spec["devices"]]
    edit_sets.append(spec.get("containerEdits", {}))  # claim-common env
    for edits in edit_sets:
        for kv in edits.get("env", []) or []:
            k, _, v = kv.partition("=")
            env[k] = v
    return env


ENV_CASES = {
    # test_distributed_e2e.py::TestLaunchEnvInjection, by its arguments.
    "channel_prepare_injects_coordinator": (0, ["w0.slice", "w1.slice"],
                                            None),
    "no_hostnames_no_invented_coordinator": (0, [], None),
    "channel_only_claim_still_carries_worker_id": (
        1, ["w0.slice", "w1.slice"], ["ici-channel-3"]),
}


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_launch_env_and_coordinator_match_the_reference(
        case, tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_DRA_COORDINATOR_BASE_PORT", "9000")
    host_id, hostnames, devices = ENV_CASES[case]
    envs, coordinators = [], []
    for side in SIDES:
        root = tmp_path / str(side)
        env = _prepare_host_env(side, root, host_id, hostnames, devices)
        for key in ENV_KEYS:
            monkeypatch.delenv(key, raising=False)
        for key in ENV_KEYS:
            if key in env:
                monkeypatch.setenv(key, env[key])
        envs.append({k: v.replace(str(root), "<dir>")
                     for k, v in env.items()})
        coordinators.append(
            side("parallel.distributed").coordinator_from_env())
    assert envs[1] == envs[0]
    assert coordinators[1] == coordinators[0]
    port_env = envs[1]
    if case == "channel_prepare_injects_coordinator":
        assert port_env["TPU_WORKER_HOSTNAMES"] == "w0.slice,w1.slice"
        # Port = base + channel, so concurrent jobs on one slice get
        # disjoint rendezvous.
        assert port_env["TPU_DRA_COORDINATOR"] == "w0.slice:9003"
        assert port_env["TPU_WORKER_ID"] == "0"
        assert coordinators[1] == "w0.slice:9003"
    elif case == "no_hostnames_no_invented_coordinator":
        assert "TPU_DRA_COORDINATOR" not in port_env
        assert "TPU_WORKER_HOSTNAMES" not in port_env
        assert coordinators[1] is None
    else:
        assert port_env["TPU_WORKER_ID"] == "1"
        assert port_env["TPU_DRA_COORDINATOR"].startswith("w0.slice:")


@pytest.mark.parametrize("env", [
    {},
    {"TPU_DRA_COORDINATOR": "10.0.0.1:1234"},
    {"TPU_WORKER_HOSTNAMES": "h0, h1,h2"},
    {"TPU_WORKER_HOSTNAMES": " h0 ,h1", "TPU_DRA_COORDINATOR_PORT": "9999"},
    {"TPU_DRA_COORDINATOR": "c:1", "TPU_WORKER_HOSTNAMES": "h0,h1"},
    {"TPU_DRA_COORDINATOR": "", "TPU_WORKER_HOSTNAMES": ""},
], ids=lambda e: ",".join(sorted(e)) or "empty")
def test_coordinator_from_env_matches_the_reference(env, monkeypatch):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = [side("parallel.distributed").coordinator_from_env()
           for side in SIDES]
    assert got[1] == got[0]


def test_single_host_applies_sharing_and_forms_no_group(monkeypatch):
    """One process, no hostnames: the sharing envelope is applied (a
    time-shared claim's marker is set) and no process group forms."""
    import torch.distributed as dist

    from k8s_dra_driver_tpu_torch.parallel import initialize_distributed
    from k8s_dra_driver_tpu_torch.parallel import shim

    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("TPU_DRA_SHARING", "time-shared")
    monkeypatch.delenv("TPU_DRA_SHIM_APPLIED", raising=False)
    for mod in (shim, REF("parallel.shim")):
        monkeypatch.setattr(mod, "_active", None)
    assert initialize_distributed() is False
    assert os.environ["TPU_DRA_SHIM_APPLIED"] == "1"
    assert shim._active.mode == "time-shared"
    assert not dist.is_initialized()
    # The reference does the same (no JAX cluster forms).
    monkeypatch.delenv("TPU_DRA_SHIM_APPLIED")
    assert REF("parallel.distributed").initialize_distributed() is False


def test_gang_claim_forms_a_process_group(tmp_path, monkeypatch):
    """Two REAL processes take the port's claim-spec env (the CDI merge)
    and form one gloo group over it: each holds 4 x (pid + 1), so the
    all-reduced tensor sums to 4 x 1 + 4 x 2 over 4 elements: 12."""
    port = _free_port()
    # ici-channel-3 is claimed by _make_claim: pick base so base+3 == port.
    monkeypatch.setenv("TPU_DRA_COORDINATOR_BASE_PORT", str(port - 3))
    hostnames = ["127.0.0.1", "127.0.0.1"]
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER_SRC)
    procs = []
    for host_id in (0, 1):
        claim_env = _prepare_host_env(PORT, tmp_path, host_id, hostnames)
        assert claim_env["TPU_DRA_COORDINATOR"] == f"127.0.0.1:{port}"
        env = dict(os.environ)
        env.update(claim_env)
        env["PYTHONPATH"] = REPO_ROOT
        env["CUDA_VISIBLE_DEVICES"] = ""
        procs.append(subprocess.Popen(
            [sys.executable, str(worker_py)], env=env, cwd=REPO_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err += f"\n(killed after {WORKER_TIMEOUT_S} s)"
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err}"
        assert "RESULT 2 12.0" in out, f"unexpected output:\n{out}\n{err}"
