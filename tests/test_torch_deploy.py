"""The port installed as an H100 DRA driver: the unchanged chart with
``values-h100.yaml``, the image of ``deployments/container/Dockerfile.torch``
and the console scripts of ``pyproject.toml``.

Twin of ``tests/test_helm_render.py``'s flag checks (``:104``) for the
port: the chart renders through ``tools/helm_render.py`` after helm's own
value coalescing (``tools/chart_torch.py``), and every flag and env var
it hands the plugin and the controller must parse with the port's
parsers. The rendered DeviceClasses' CEL selectors, run through the
port's CEL evaluator and sim allocator, must select the devices that
``FakeChipLib(generation="h100")`` publishes. The image and the kind e2e
need docker, kind and a network; these tests hold what can be held
without them.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import chart_torch  # noqa: E402

from k8s_dra_driver_tpu_torch.controller import main as controller_main  # noqa: E402
from k8s_dra_driver_tpu_torch.kube import NODES, FakeKubeClient  # noqa: E402
from k8s_dra_driver_tpu_torch.kube import cel  # noqa: E402
from k8s_dra_driver_tpu_torch.kube.allocator import (  # noqa: E402
    AllocationError,
    ReferenceAllocator,
)
from k8s_dra_driver_tpu_torch.kube.resourceslice import (  # noqa: E402
    DriverResources,
    Pool,
    ResourceSliceController,
)
from k8s_dra_driver_tpu_torch.plugin import main as plugin_main  # noqa: E402
from k8s_dra_driver_tpu_torch.tpulib import FakeChipLib, deviceinfo  # noqa: E402

DRIVER = "tpu.google.com"
MIG_LAYOUT = [("3g.40gb", 0), ("2g.20gb", 4), ("1g.10gb", 6)]
MIG_NAMES = ["tpu-0-mig-9-0-4", "tpu-0-mig-14-4-2", "tpu-0-mig-19-6-1"]


@pytest.fixture(scope="module")
def h100():
    return chart_torch.render()


def by_kind(objs, kind):
    return [o for o in objs if o.get("kind") == kind]


def env_values(ctr, node="node-a"):
    """The container's env as the kubelet hands it over: a fieldRef to
    the node's name reads ``node``."""
    out = {}
    for e in ctr.get("env", []):
        if "value" in e:
            out[e["name"]] = str(e["value"])
        else:
            assert e["valueFrom"]["fieldRef"]["fieldPath"] == "spec.nodeName"
            out[e["name"]] = node
    return out


def parsed(build_parser, monkeypatch, env, args):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    return build_parser().parse_args(args)


@pytest.mark.parametrize("extra", [{}, {"plugin": {"fakeTopology": "2x1x1"}}],
                         ids=["h100", "h100-fake"])
def test_plugin_flags_and_env_parse_with_the_ports_parser(monkeypatch,
                                                          extra):
    """Every rendered flag exists on the port's plugin CLI and the whole
    command line parses, and each env var the DaemonSet sets is one the
    parser reads (its default moves with it)."""
    values = chart_torch.coalesce(chart_torch.chart_values(), extra)
    renderer = chart_torch.Renderer(str(chart_torch.CHART))
    renderer.root_ctx["Values"] = values
    ctr = chart_torch.container(renderer.objects(), "DaemonSet")
    opts = {o for a in plugin_main.build_parser()._actions
            for o in a.option_strings}
    for arg in ctr["args"]:
        assert arg.split("=")[0] in opts, f"chart passes unknown flag {arg}"
    env = env_values(ctr)
    args = parsed(plugin_main.build_parser, monkeypatch, env, ctr["args"])
    assert args.device_classes == "chip,tensorcore"
    assert (args.node_name, args.http_port, args.log_level) == \
        ("node-a", 8081, "INFO")
    assert (args.driver_root, args.driver_root_ctr_path, args.dev_root) == \
        ("/", "/driver-root", "/")
    if extra:
        assert (args.fake_topology, args.fake_generation) == \
            ("2x1x1", "h100")
    else:
        assert args.fake_topology == ""


def test_every_env_var_moves_a_default(monkeypatch):
    for kind, build_parser in (("DaemonSet", plugin_main.build_parser),
                               ("Deployment", controller_main.build_parser)):
        ctr = chart_torch.container(chart_torch.render(), kind)
        for name, value in env_values(ctr).items():
            with monkeypatch.context() as m:
                m.delenv(name, raising=False)
                before = vars(build_parser().parse_args([]))
                m.setenv(name, value)
                after = vars(build_parser().parse_args([]))
            moved = {k for k in after if after[k] != before[k]}
            assert moved, f"{kind} env {name} is read by no flag"


def test_controller_command_line_parses(monkeypatch, h100):
    ctr = chart_torch.container(h100, "Deployment")
    args = parsed(controller_main.build_parser, monkeypatch,
                  env_values(ctr), ctr.get("args", []))
    assert (args.http_port, args.log_level) == (8082, "INFO")


def flat(obj, path=()):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from flat(v, path + (k,))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from flat(v, path + (i,))
    else:
        yield path, obj


def test_the_render_differs_from_the_default_only_where_the_overlay_sets(
        h100):
    """The image, the device classes (no ici class, no ici in the
    plugin's flag), the node selector and the tolerations: nothing
    else."""
    def keyed(objs):
        return {(o["kind"], o["metadata"]["name"]): dict(flat(o))
                for o in objs}

    base, got = keyed(chart_torch.render(None)), keyed(h100)
    assert base.keys() - got.keys() == {("DeviceClass", "ici.tpu.google.com")}
    assert got.keys() <= base.keys()
    ctr = ("spec", "template", "spec", "containers", 0)
    pod = ("spec", "template", "spec")
    diffs = {}
    for key in got:
        for path in base[key].keys() | got[key].keys():
            if base[key].get(path) != got[key].get(path):
                diffs.setdefault(key, set()).add(path)
    assert diffs == {
        ("DaemonSet", "tpu-dra-plugin"): {
            ctr + ("image",), ctr + ("args", 0),
            pod + ("nodeSelector", "tpu.google.com/chips"),
            pod + ("nodeSelector", "nvidia.com/gpu.present"),
            pod + ("tolerations", 0, "key"),
            pod + ("tolerations", 0, "operator"),
            pod + ("tolerations", 0, "effect")},
        ("Deployment", "tpu-dra-controller"): {ctr + ("image",)},
    }
    ds = got[("DaemonSet", "tpu-dra-plugin")]
    assert ds[ctr + ("image",)] == "tpu-dra-driver-torch:latest"
    assert ds[ctr + ("args", 0)] == "--device-classes=chip,tensorcore"
    assert ds[pod + ("nodeSelector", "nvidia.com/gpu.present")] == "true"
    assert ds[pod + ("tolerations", 0, "key")] == "nvidia.com/gpu"


def test_helm_coalescing_deletes_a_key_set_to_null():
    base = {"a": {"x": 1, "y": 2}, "b": [1], "c": 3}
    assert chart_torch.coalesce(base, {"a": {"x": None, "z": 4},
                                       "b": [2], "c": None}) == \
        {"a": {"y": 2, "z": 4}, "b": [2]}
    assert base == {"a": {"x": 1, "y": 2}, "b": [1], "c": 3}


def device_classes(objs):
    return {o["metadata"]["name"]: [s["cel"]["expression"]
                                    for s in o["spec"]["selectors"]]
            for o in by_kind(objs, "DeviceClass")}


def publish(devs):
    client = FakeKubeClient()
    client.create(NODES, {"metadata": {"name": "gpu-node", "uid": "u-1"}})
    ctrl = ResourceSliceController(
        client, DRIVER, scope="gpu-node",
        owner={"kind": "Node", "name": "gpu-node", "uid": "u-1"})
    ctrl.update(DriverResources(pools={"gpu-node": Pool(
        devices=[d.get_device() for _, d in sorted(devs.items())],
        shared_counters=deviceinfo.counter_sets(devs),
        node_name="gpu-node")}))
    ctrl.sync_once()
    return client


def claim(uid, class_name):
    return {"metadata": {"name": uid, "namespace": "ns", "uid": uid},
            "spec": {"devices": {"requests": [
                {"name": "r", "deviceClassName": class_name}]}}}


def granted(c):
    return [r["device"] for r in
            c["status"]["allocation"]["devices"]["results"]]


@pytest.mark.parametrize("mig", [None, {0: MIG_LAYOUT}],
                         ids=["whole-gpus", "gpu0-in-mig-mode"])
def test_device_classes_select_the_fake_h100_devices(h100, mig):
    """The CEL of each rendered DeviceClass, evaluated by the port on every
    device a fake H100 node publishes: ``chip`` selects the whole GPUs,
    ``tensorcore`` the MIG devices. The sim allocator, given the rendered
    classes, places a claim of each class on exactly those devices."""
    classes = device_classes(h100)
    assert sorted(classes) == ["tensorcore.tpu.google.com", DRIVER]
    lib = FakeChipLib(generation="h100", topology="2x1x1", mig=mig)
    devs = lib.enumerate_all_possible_devices({"chip", "tensorcore"})
    gpus = ["tpu-1"] if mig else ["tpu-0", "tpu-1"]
    migs = MIG_NAMES if mig else []
    assert sorted(devs) == sorted(gpus + migs)
    selected = {}
    for name, exprs in classes.items():
        selected[name] = sorted(
            dev for dev, info in devs.items()
            if all(cel.evaluate(e, DRIVER,
                                info.get_device()["basic"]["attributes"])
                   for e in exprs))
    assert selected == {DRIVER: sorted(gpus),
                        "tensorcore.tpu.google.com": sorted(migs)}
    alloc = ReferenceAllocator(publish(devs), driver_name=DRIVER,
                               device_classes=classes)
    for name, want in ((DRIVER, gpus),
                       ("tensorcore.tpu.google.com", migs)):
        got = []
        for i in range(len(want)):
            c = claim(f"{name}-{i}", name)
            alloc.allocate(c)
            got += granted(c)
        assert sorted(got) == sorted(want)
        with pytest.raises(AllocationError):
            alloc.allocate(claim(f"{name}-over", name))


def test_the_image_runs_the_ports_console_scripts(h100):
    """The chart's command names and the image's entrypoint map, through
    the image's links, to console scripts ``pyproject.toml`` declares for
    the port; each imports without torch, numpy, jax, grpc or protobuf."""
    commands = chart_torch.image_commands()
    scripts = chart_torch.console_scripts()
    want = {"tpu-dra-plugin": "k8s_dra_driver_tpu_torch.plugin.main:main",
            "tpu-dra-controller":
                "k8s_dra_driver_tpu_torch.controller.main:main",
            "tpu-dra-inspect": "k8s_dra_driver_tpu_torch.plugin.inspect:main"}
    assert {k: scripts[k + "-torch"] for k in want} == want
    assert commands == dict(want, ENTRYPOINT=want["tpu-dra-plugin"])
    for kind in ("DaemonSet", "Deployment"):
        (command,) = chart_torch.container(h100, kind)["command"]
        assert commands[command].startswith("k8s_dra_driver_tpu_torch.")
    code = "import sys\n" + "".join(
        f"from {m} import {f}\nassert callable({f})\n"
        for m, f in (v.split(":") for v in want.values())) + (
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'grpc', 'k8s_dra_driver_tpu') or "
        "m.startswith('google.protobuf'))\nassert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_image_installs_no_torch_grpc_or_protobuf():
    text = chart_torch.DOCKERFILE.read_text()
    installs = [ln for ln in text.splitlines() if "pip install" in ln]
    assert any(ln.rstrip().endswith("pip install --no-cache-dir pyyaml")
               for ln in installs)
    for banned in ("torch", "grpcio", "protobuf", "numpy"):
        assert not any(banned in ln for ln in installs), banned
    assert "native" not in text.split("FROM python:3.12-slim AS build")[1]
    assert "csrc/*.cuh" in (ROOT / "pyproject.toml").read_text()


@pytest.mark.parametrize("script", ["e2e-torch.sh",
                                    "install-dra-driver-torch.sh"])
def test_the_kind_scripts_skip_without_their_tools(tmp_path, script):
    """Exit 3 when docker, kind, kubectl or helm is missing: a PATH holding
    only the shell and ``dirname``."""
    path = ROOT / "demo" / "clusters" / "kind" / script
    assert os.access(path, os.X_OK)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for tool in ("bash", "dirname"):
        (bin_dir / tool).symlink_to(subprocess.check_output(
            ["bash", "-c", f"command -v {tool}"], text=True).strip())
    proc = subprocess.run([str(bin_dir / "bash"), str(path)],
                          env={"PATH": str(bin_dir)}, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 3, (proc.stdout, proc.stderr)
    assert "SKIP" in proc.stderr
