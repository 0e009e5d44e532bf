"""The port stands alone: no JAX, nothing of the JAX package, and no quiet
fall back to the CPU.

The machine with the card has no JAX, so ``k8s_dra_driver_tpu_torch`` and
``chip_smoke.py`` must import neither ``jax`` nor ``k8s_dra_driver_tpu``
(as a module -- ``k8s_dra_driver_tpu_torch`` merely shares the prefix).
It has no ``grpcio`` or ``protobuf`` either (the sandbox does, so a stray
import would pass here and fail there): neither ``grpc`` nor
``google.protobuf`` may be imported.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from k8s_dra_driver_tpu_torch import resolve_device
from k8s_dra_driver_tpu_torch.models import (
    DecodeEngine,
    generate,
    init_params,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    moe,
)
from k8s_dra_driver_tpu_torch.models.llama import PRESETS
from k8s_dra_driver_tpu_torch.models.speculative import speculative_generate
from k8s_dra_driver_tpu_torch.parallel.elastic import ElasticTrainer

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "k8s_dra_driver_tpu", "grpc")
# Forbidden below a top-level name that is itself allowed.
FORBIDDEN_PACKAGES = ("google.protobuf",)


# The port's gate: the twins of the reference's gate tools and of its
# quickstart demo.
GATE_TWINS = ("tools/run_doctor_sim_torch.py", "tools/run_alloc_bench_torch.py",
              "tools/verify_metrics_torch.py",
              "tools/sim_check_allocation_torch.py",
              "tools/run_defrag_smoke_torch.py",
              "tools/run_fleet_smoke_torch.py",
              "tools/run_elastic_smoke_torch.py",
              "tools/run_decode_smoke_torch.py", "tools/run_kv_smoke_torch.py",
              "tools/run_trace_smoke_torch.py",
              "tools/run_compute_smoke_torch.py",
              "tools/run_moe_smoke_torch.py", "tools/_gate_torch.py",
              "tools/run_gateway_smoke_torch.py", "tools/lint_torch.py",
              "_decodebench_torch.py", "demo/run_demo_sim_torch.py")


def _port_files():
    files = sorted((ROOT / "k8s_dra_driver_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"] + [ROOT / f for f in GATE_TWINS]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN or any(
        module == p or module.startswith(p + ".") for p in FORBIDDEN_PACKAGES)


def test_static_scan_finds_no_jax_or_reference_import():
    files = _port_files()
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert not bad, bad
    assert not _forbidden("k8s_dra_driver_tpu_torch.models")
    assert _forbidden("k8s_dra_driver_tpu.models")
    assert _forbidden("grpc.aio") and _forbidden("google.protobuf.message")
    assert not _forbidden("google")


def test_gate_twins_import_no_reference_tool():
    """A twin keeps its own copy of what it needs from its reference (the
    exposition parser, ``spread_flags``, the lint checks): it imports no
    module of ``tools/``, ``demo/`` or the repo root (``_decodebench``)
    that is not itself a twin."""
    reference_tools = {p.stem for d in ("tools", "demo", ".")
                       for p in (ROOT / d).glob("*.py")
                       if not p.stem.endswith("_torch")
                       and p.stem != "chip_smoke"}
    assert {"verify_metrics", "run_moe_smoke", "run_demo_sim", "lint",
            "_decodebench"} <= reference_tools
    bad = [(f, m) for f in GATE_TWINS for m in _imported_modules(ROOT / f)
           if m.split(".")[0] in reference_tools]
    assert not bad, bad
    assert all((ROOT / f).exists() for f in GATE_TWINS)


def test_importing_the_gate_twins_loads_no_jax():
    code = (
        "import sys\n"
        "sys.path[:0] = ['tools', 'demo']\n"
        + "".join(f"import {Path(f).stem}\n" for f in GATE_TWINS)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'k8s_dra_driver_tpu', 'grpc') or "
        "m.startswith('google.protobuf'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# The driver's control plane, by the sets of modules that each of its
# processes imports, as paths below either package. The port's sets load
# neither torch nor numpy, as the reference's load neither jax nor numpy:
# each package's driver image carries no array library.
CONTROL_PLANE = {
    "gateway": ("serving_gateway", "utils.metrics"),
    "device-layer": ("tpulib", "tpulib._nvml", "tpulib.driverroot", "cdi",
                     "plugin", "parallel.shim", "api.v1alpha1", "utils.fs"),
    "control-plane": ("kube", "kube.allocator", "kube.defrag_executor",
                      "utils.cli"),
    "kubelet-plugin": ("kube.protos", "kube.protos.dra_v1alpha4",
                       "kube.protos.pluginregistration_v1", "plugin.driver",
                       "plugin.main", "plugin.inspect"),
    "controller-fleetsim-doctor": ("controller", "controller.main",
                                   "fleetsim", "doctor"),
}
# The reference's twins of those sets: its NVML-free discovery shim and
# its generated protobuf modules stand at the port's NVML binding and
# hand-written messages. Its ``parallel`` package loads the mesh surface
# (and so jax) wherever jax is installed, and skips it where it is not, as
# in its driver image: ``parallel.shim`` is left out of its set here.
REFERENCE_CONTROL_PLANE = {
    "gateway": CONTROL_PLANE["gateway"],
    "device-layer": ("tpulib", "tpulib._native", "tpulib.driverroot", "cdi",
                     "plugin", "api.v1alpha1", "utils.fs"),
    "control-plane": CONTROL_PLANE["control-plane"],
    "kubelet-plugin": ("kube.protos", "kube.protos.dra_v1alpha4_pb2",
                       "kube.protos.pluginregistration_v1_pb2",
                       "plugin.driver", "plugin.main", "plugin.inspect"),
    "controller-fleetsim-doctor": CONTROL_PLANE["controller-fleetsim-doctor"],
}


def _port(name):
    return tuple(f"k8s_dra_driver_tpu_torch.{m}" for m in CONTROL_PLANE[name])


@pytest.mark.parametrize("modules", [
    ("k8s_dra_driver_tpu_torch.models.serving",),
    ("k8s_dra_driver_tpu_torch.serving_gateway",
     "k8s_dra_driver_tpu_torch.utils.metrics"),
    ("k8s_dra_driver_tpu_torch.models.speculative",),
    ("k8s_dra_driver_tpu_torch.models.compute_telemetry",),
    ("k8s_dra_driver_tpu_torch.parallel.collectives",),
    ("k8s_dra_driver_tpu_torch.parallel.pipeline",
     "k8s_dra_driver_tpu_torch.parallel.ring",
     "k8s_dra_driver_tpu_torch.parallel.layout"),
    ("k8s_dra_driver_tpu_torch.models.remat",
     "k8s_dra_driver_tpu_torch.models.checkpoint",
     "k8s_dra_driver_tpu_torch.parallel.elastic",
     "k8s_dra_driver_tpu_torch.parallel.distributed"),
    _port("device-layer"),
    _port("control-plane"),
    _port("kubelet-plugin"),
    _port("controller-fleetsim-doctor"),
], ids=["engine", "gateway", "speculative", "compute-telemetry",
        "collectives", "pipeline-ring", "remat-checkpoint", "device-layer", "control-plane",
        "kubelet-plugin", "controller-fleetsim-doctor"])
def test_importing_the_port_loads_no_jax(modules):
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in modules)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'k8s_dra_driver_tpu', 'grpc') or "
        "m.startswith('google.protobuf'))\n"
        "assert not bad, bad\n"
        # The control plane reads a kubeconfig through PyYAML only when
        # one is read: the card's machine need not have it.
        + ("assert 'yaml' not in sys.modules, 'yaml'\n"
           if "k8s_dra_driver_tpu_torch.kube" in modules else "")
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("package,name", [
    (package, name) for package in ("port", "reference")
    for name in CONTROL_PLANE])
def test_the_control_plane_loads_no_array_library(package, name):
    """A driver process imports no array library: the port's control
    plane loads neither torch nor numpy (its package imports torch only
    where a device is resolved), and the reference's neither jax nor
    numpy."""
    if package == "port":
        modules, banned = _port(name), ("torch", "numpy", "jax")
    else:
        modules = tuple(f"k8s_dra_driver_tpu.{m}"
                        for m in REFERENCE_CONTROL_PLANE[name])
        banned = ("jax", "jaxlib", "numpy")
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in modules)
        + f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{banned!r})\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_kubelet_plugin_runs_where_grpc_and_protobuf_are_missing():
    """The card's machine has neither package: with an import finder
    refusing both, the kubelet-facing modules import, the CLI parses its
    flags, and a Driver serves its two unix sockets: the port's own
    client and stubs register with it and send a prepare in wire form
    over the plugin socket."""
    code = """
import sys, tempfile

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] == 'grpc' or name == 'google.protobuf' or \\
                name.startswith('google.protobuf.'):
            raise ImportError(f'{name} is not installed here')
        return None

sys.meta_path.insert(0, Refuse())
try:
    import grpc
except ImportError:
    pass
else:
    raise AssertionError('the finder let grpc through')
import os
from k8s_dra_driver_tpu_torch.kube.protos import dra_v1alpha4 as drapb
from k8s_dra_driver_tpu_torch.kube.protos import pluginregistration_v1 as regpb
from k8s_dra_driver_tpu_torch.plugin import driver, grpc_uds, inspect, main
from k8s_dra_driver_tpu_torch.plugin.grpc_services import NodeStub, RegistrationStub
from k8s_dra_driver_tpu_torch.tpulib import FakeChipLib
args = main.build_parser().parse_args(['--no-kube', '--node-name', 'x'])
assert args.no_kube and args.node_name == 'x'
root = tempfile.mkdtemp()
d = driver.Driver(driver.DriverConfig(
    node_name='x', chiplib=FakeChipLib(topology='2x2x1'),
    cdi_root=root + '/cdi', plugin_root=root + '/p',
    registrar_root=root + '/r', state_root=root + '/s',
    cleanup_interval_seconds=0, device_watch_interval_seconds=0,
    audit_interval_seconds=0))
d.start()
assert isinstance(d.config.transport, grpc_uds.SocketTransport)
assert d.plugin.serving
with grpc_uds.Channel(d.config.registrar_socket) as ch:
    info = RegistrationStub(ch).GetInfo(regpb.InfoRequest(), timeout=10)
    assert info.endpoint == d.config.plugin_socket, info
    RegistrationStub(ch).NotifyRegistrationStatus(
        regpb.RegistrationStatus(plugin_registered=True), timeout=10)
assert d.plugin.registration_status()['pluginRegistered']
req = drapb.NodePrepareResourcesRequest(claims=[drapb.Claim(uid='u')])
with grpc_uds.Channel(d.config.plugin_socket) as ch:
    out = NodeStub(ch).NodePrepareResources(req, timeout=10)
assert 'no kube client' in out.claims['u'].error, out
d.shutdown()
assert not os.path.exists(d.config.plugin_socket)
assert not os.path.exists(d.config.registrar_socket)
bad = sorted(m for m in sys.modules if m.split('.')[0] == 'grpc'
             or m.startswith('google.protobuf'))
assert not bad, bad
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_card():
    """``device=None`` means CUDA: on a host without one the entry points
    raise instead of running on the CPU."""
    cfg = PRESETS["tiny"]
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        moe.init_params(moe.MOE_PRESETS["tiny-moe"], seed=0)
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(params, [[1, 2, 3]], cfg, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        speculative_generate(params, params, [[1, 2, 3]], cfg, cfg, 2)
    opt = make_optimizer(warmup_steps=1, total_steps=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(cfg, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ElasticTrainer(cfg, opt, ["tpu-0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"
