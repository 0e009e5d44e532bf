"""``tools/lint_torch.py`` (``make lint-torch``): the port's lint gate.

Its own copy of ``tools/lint.py``'s checks, over the port's files, with
the metric rules keyed on ``k8s_dra_driver_tpu_torch`` and TPM06's enums
read from the port's ``kube/allocator.py``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import lint_torch  # noqa: E402


def test_the_port_lints_clean(capsys):
    assert lint_torch.main([]) == 0
    assert "0 findings" in capsys.readouterr().err


def test_default_roots_are_the_ports_files():
    roots = {str(p) for p in lint_torch.default_roots()}
    assert {"k8s_dra_driver_tpu_torch", "chip_smoke.py",
            "_decodebench_torch.py", "demo/run_demo_sim_torch.py",
            "tools/lint_torch.py",
            "tools/run_gateway_smoke_torch.py"} <= roots
    assert not any(r.startswith(("k8s_dra_driver_tpu/", "tests"))
                   or r in ("k8s_dra_driver_tpu", "tools/lint.py")
                   for r in roots)


def test_alloc_enums_come_from_the_ports_allocator():
    assert lint_torch._ALLOC_ENUMS_PATH == \
        ROOT / "k8s_dra_driver_tpu_torch" / "kube" / "allocator.py"
    enums = lint_torch._alloc_enums()
    assert enums["stage"] and enums["reason"]


@pytest.mark.parametrize("source,code", [
    ("from x import Counter\nc = Counter('bad_total', 'h')\n", "TPM01"),
    ("from x import Counter\nc = Counter('tpu_dra_x', 'h')\n", "TPM02"),
    ("from x import Gauge\ng = Gauge('tpu_dra_x', '')\n", "TPM03"),
    ("def f(m):\n    m.inc(chip='0')\n", "TPM04"),
    ("from x import Counter\nc = Counter('tpu_dra_gw_x_total', 'h')\n",
     "TPM05"),
    ("from x import Counter\nc = Counter('tpu_dra_alloc_x_total', 'h')\n"
     "c.inc(stage='nope')\n", "TPM06"),
    ("import os\n", "F401"),
    ("def f(x=[]):\n    return x\n", "B006"),
], ids=["prefix", "suffix", "help", "per-chip", "family", "alloc-enum",
        "unused-import", "mutable-default"])
def test_a_planted_finding_is_reported_in_the_package(tmp_path, source,
                                                       code):
    path = tmp_path / "k8s_dra_driver_tpu_torch" / "plugin" / "x.py"
    path.parent.mkdir(parents=True)
    path.write_text(source)
    assert [f.code for f in lint_torch.lint_file(path)] == [code]


def test_metric_rules_stay_off_outside_the_package(tmp_path):
    path = tmp_path / "tools" / "x_torch.py"
    path.parent.mkdir()
    path.write_text("from x import Counter\nc = Counter('bad', '')\n")
    assert lint_torch.lint_file(path) == []
