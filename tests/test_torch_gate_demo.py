"""The port's hermetic quickstart and its allocation cross-check against
the reference's recording and tool.

``demo/run_demo_sim_torch.py`` prepares every quickstart claim over the
port's own gRPC sockets (``plugin/grpc_uds.py``); its output must equal
the fenced block of ``docs/demo-transcript.md`` byte for byte, the
recording ``tests/test_demo_sim.py`` holds to the reference's live run.
``tools/sim_check_allocation_torch.py`` must give the reference tool's
verdict, exit code and lines on slices published by either package's
fakes.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def recorded_transcript() -> str:
    text = open(os.path.join(REPO, "docs/demo-transcript.md")).read()
    start = text.index("```\n") + 4
    end = text.index("\n```", start)
    return text[start:end].strip("\n")


@pytest.fixture(scope="module")
def demo_run():
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "demo/run_demo_sim_torch.py")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )


def test_demo_twin_prints_the_recorded_transcript(demo_run):
    assert demo_run.returncode == 0, demo_run.stdout + demo_run.stderr
    assert demo_run.stdout.strip("\n") == recorded_transcript()


def test_demo_twin_prepares_every_spec_over_its_sockets(demo_run):
    import glob

    assert "demo OK: 0 failing spec claim(s)" in demo_run.stdout
    for spec in glob.glob(os.path.join(REPO, "demo/specs/quickstart/*.yaml")):
        assert os.path.relpath(spec, REPO) in demo_run.stdout, spec
    assert demo_run.stdout.count("prepared, CDI") >= 8


def test_demo_twin_serves_through_grpc_uds():
    """The demo's kubelet side is the port's own client on the Driver's
    plugin socket: no in-process transport stands in for it."""
    source = open(os.path.join(REPO, "demo/run_demo_sim_torch.py")).read()
    assert "grpc_uds.Channel(config.plugin_socket)" in source
    assert "LocalTransport" not in source


# -- sim_check_allocation ------------------------------------------------------


def publish(package: str) -> list:
    """A v5e 2x2x1 node's chips published by ``package``'s fakes, as
    tests/test_e2e_kind.py publishes them."""
    import importlib

    kube = importlib.import_module(f"{package}.kube")
    rs = importlib.import_module(f"{package}.kube.resourceslice")
    tpulib = importlib.import_module(f"{package}.tpulib")
    client = kube.FakeKubeClient()
    lib = tpulib.FakeChipLib(generation="v5e", topology="2x2x1", slice_id="s")
    lib.init()
    devices = lib.enumerate_all_possible_devices({"chip"})
    ctl = rs.ResourceSliceController(client, "tpu.google.com", scope="n1")
    ctl.update(rs.DriverResources(pools={"n1": rs.Pool(
        devices=[d.get_device() for d in devices.values()], node_name="n1",
    )}))
    ctl.sync_once()
    return client.list(kube.RESOURCE_SLICES)


def claim(device, count=None, uid="u1"):
    request = {"name": "r", "deviceClassName": "tpu.google.com"}
    if count is not None:
        request.update(allocationMode="ExactCount", count=count)
    out = {"metadata": {"name": f"c-{uid}", "namespace": "d", "uid": uid},
           "spec": {"devices": {"requests": [request]}}}
    if device is not None:
        out["status"] = {"allocation": {"devices": {"results": [
            {"request": "r", "driver": "tpu.google.com", "device": device,
             "pool": "n1"}]}}}
    return out


CASES = {
    "agreement": lambda: [claim("tpu-0")],
    "unknown_real_device": lambda: [claim("tpu-99")],
    "unallocated_claims": lambda: [claim(None, uid="u1"),
                                   claim(None, count=2, uid="u2")],
    "no_claims": lambda: [],
}


def load_tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def run_tool(name, tmp_path, slices, claims, monkeypatch, capsys):
    """The tool's main in process on the two files: (exit code, stdout,
    stderr)."""
    sf, cf = tmp_path / "slices.json", tmp_path / "claims.json"
    sf.write_text(json.dumps({"items": slices}))
    cf.write_text(json.dumps({"items": claims}))
    monkeypatch.setattr(sys, "argv", [name, str(sf), str(cf)])
    capsys.readouterr()
    rc = load_tool(name).main()
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("publisher", ["k8s_dra_driver_tpu",
                                       "k8s_dra_driver_tpu_torch"])
@pytest.mark.parametrize("case", list(CASES))
def test_sim_check_verdict_equals_the_reference(publisher, case, tmp_path,
                                                monkeypatch, capsys):
    slices = publish(publisher)
    claims = CASES[case]()
    want = run_tool("sim_check_allocation", tmp_path, slices, claims,
                    monkeypatch, capsys)
    got = run_tool("sim_check_allocation_torch", tmp_path, slices, claims,
                   monkeypatch, capsys)
    assert got == want
    assert got[0] == (0 if case in ("agreement", "unallocated_claims") else 1)


def test_sim_check_empty_slices_fail_as_the_reference(tmp_path, monkeypatch,
                                                      capsys):
    want = run_tool("sim_check_allocation", tmp_path, [], [claim("tpu-0")],
                    monkeypatch, capsys)
    got = run_tool("sim_check_allocation_torch", tmp_path, [],
                   [claim("tpu-0")], monkeypatch, capsys)
    assert got == want and got[0] == 1
