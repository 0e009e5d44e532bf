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

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "k8s_dra_driver_tpu", "grpc")
# Forbidden below a top-level name that is itself allowed.
FORBIDDEN_PACKAGES = ("google.protobuf",)


def _port_files():
    files = sorted((ROOT / "k8s_dra_driver_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "tools" / "run_doctor_sim_torch.py"]


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


@pytest.mark.parametrize("modules", [
    ("k8s_dra_driver_tpu_torch.models.serving",),
    ("k8s_dra_driver_tpu_torch.serving_gateway",
     "k8s_dra_driver_tpu_torch.utils.metrics"),
    ("k8s_dra_driver_tpu_torch.models.speculative",),
    ("k8s_dra_driver_tpu_torch.models.compute_telemetry",),
    ("k8s_dra_driver_tpu_torch.parallel.collectives",),
    ("k8s_dra_driver_tpu_torch.models.remat",
     "k8s_dra_driver_tpu_torch.models.checkpoint"),
    ("k8s_dra_driver_tpu_torch.tpulib",
     "k8s_dra_driver_tpu_torch.tpulib._nvml",
     "k8s_dra_driver_tpu_torch.tpulib.driverroot",
     "k8s_dra_driver_tpu_torch.cdi",
     "k8s_dra_driver_tpu_torch.plugin",
     "k8s_dra_driver_tpu_torch.parallel.shim",
     "k8s_dra_driver_tpu_torch.api.v1alpha1",
     "k8s_dra_driver_tpu_torch.utils.fs"),
    ("k8s_dra_driver_tpu_torch.kube",
     "k8s_dra_driver_tpu_torch.kube.allocator",
     "k8s_dra_driver_tpu_torch.kube.defrag_executor",
     "k8s_dra_driver_tpu_torch.utils.cli"),
    ("k8s_dra_driver_tpu_torch.kube.protos",
     "k8s_dra_driver_tpu_torch.kube.protos.dra_v1alpha4",
     "k8s_dra_driver_tpu_torch.kube.protos.pluginregistration_v1",
     "k8s_dra_driver_tpu_torch.plugin.driver",
     "k8s_dra_driver_tpu_torch.plugin.main",
     "k8s_dra_driver_tpu_torch.plugin.inspect"),
    ("k8s_dra_driver_tpu_torch.controller",
     "k8s_dra_driver_tpu_torch.controller.main",
     "k8s_dra_driver_tpu_torch.fleetsim",
     "k8s_dra_driver_tpu_torch.doctor"),
], ids=["engine", "gateway", "speculative", "compute-telemetry",
        "collectives", "remat-checkpoint", "device-layer", "control-plane",
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


def test_the_kubelet_plugin_runs_where_grpc_and_protobuf_are_missing():
    """The card's machine has neither package: with an import finder
    refusing both, the kubelet-facing modules import, the CLI parses its
    flags and the in-process transport answers a prepare in wire form."""
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
from k8s_dra_driver_tpu_torch.kube.protos import dra_v1alpha4 as drapb
from k8s_dra_driver_tpu_torch.plugin import driver, inspect, main
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
req = drapb.NodePrepareResourcesRequest(claims=[drapb.Claim(uid='u')])
out = drapb.NodePrepareResourcesResponse.FromString(d.config.transport.call(
    '/v1alpha3.Node/NodePrepareResources', req.SerializeToString()))
assert 'no kube client' in out.claims['u'].error, out
d.shutdown()
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
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"
