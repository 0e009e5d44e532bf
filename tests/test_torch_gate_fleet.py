"""``tools/run_fleet_smoke_torch.py`` against ``tools/run_fleet_smoke.py``
on the default seed: the scripted day of ``fleetsim.smoke_scenario``.

Decisions only: the fleet report's deterministic fields -- admitted,
lost, unclassified and expired counts per class, the executed defrag
plan, the auditor's findings, the autoscaler's decisions, the chaos
timeline, the elastic resizes and every gate -- equal the reference
artifact's. ``TPU_DRA_FLEET_ARTIFACT`` points into the test's temporary
directory before the reference tool is imported, so no test writes
``FLEET_r01.json``; the twin writes only to an explicit ``--out``.
"""

import contextlib
import hashlib
import io
import json
import os
import sys

import pytest

from test_torch_gate_common import REPO, load_tool

RECORD = os.path.join(REPO, "FLEET_r01.json")
FIELDS = ("loss", "lossByClass", "defrag", "audit", "autoscaler", "chaos",
          "elastic", "rebalancer", "gates", "pass", "scenario")


def digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    before = digest(RECORD)
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("TPU_DRA_FLEET_ARTIFACT", str(tmp / "ref.json"))
        sys.modules.pop("run_fleet_smoke", None)
        ref = load_tool("run_fleet_smoke")
        assert ref.ARTIFACT == str(tmp / "ref.json")
        with contextlib.redirect_stdout(io.StringIO()):
            ref.main()
        with open(tmp / "ref.json") as f:
            want = json.load(f)
        twin = load_tool("run_fleet_smoke_torch")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = twin.main(["--out", str(tmp / "port.json")])
        with open(tmp / "port.json") as f:
            got = json.load(f)
    finally:
        mp.undo()
        sys.modules.pop("run_fleet_smoke", None)
    assert digest(RECORD) == before
    return want, got, rc, printed.getvalue()


@pytest.mark.parametrize("field", FIELDS)
def test_report_field_equals_the_reference(runs, field):
    want, got, _, _ = runs
    assert got[field] == want[field]


def test_zero_admitted_loss_per_class(runs):
    _, got, _, _ = runs
    for cls, row in got["lossByClass"].items():
        assert (row["lost"], row["unclassified"],
                row["expired-deadline"]) == (0, 0, 0), cls
    assert all(g["pass"] for g in got["gates"].values()) and got["pass"]


def test_twin_passes_and_writes_only_its_out(runs):
    want, got, rc, printed = runs
    assert rc == 0 and "PASS: seed=1234" in printed
    assert printed.splitlines()[0].startswith("wrote ")
    assert set(got) == set(want)
