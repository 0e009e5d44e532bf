"""``tools/run_defrag_smoke_torch.py`` against ``tools/run_defrag_smoke.py``
on the default seed and on one seed for each ``defrag.*`` crash site.

Decisions only, read from the lines both tools print and from the
twin's ``run``: the plan (its id, mover, source and target devices and
freed box), the crash site, the gang's devices and the executed steps,
and the verdict (exit code and PASS/FAIL line).
"""

import contextlib
import io
import random
import re

import pytest

from test_torch_gate_common import load_tool

# The first seed that lands on each crash site, plus the tool's default.
SITES = ("defrag.intent-write", "defrag.drain", "defrag.replace",
         "defrag.admit")
SEEDS = sorted({1234} | {next(s for s in range(1000)
                              if random.Random(s).choice(SITES) == site)
                         for site in SITES})


def main_output(tool, seed, monkeypatch) -> tuple:
    monkeypatch.setattr(tool, "SEED", seed)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        try:
            rc = tool.main() or 0
        except SystemExit as e:
            rc = e.code
    return rc, printed.getvalue()


def test_sites_are_the_reference_registry():
    from k8s_dra_driver_tpu.utils import faults as ref_faults
    from k8s_dra_driver_tpu_torch.utils import faults

    assert tuple(ref_faults.sites_in("defrag.")) == SITES
    assert tuple(faults.sites_in("defrag.")) == SITES


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_site_gang_and_verdict_equal_the_reference(seed, monkeypatch):
    want = main_output(load_tool("run_defrag_smoke"), seed, monkeypatch)
    got = main_output(load_tool("run_defrag_smoke_torch"), seed, monkeypatch)
    assert got == want
    assert got[0] == 0 and re.search(r"^PASS: ", got[1], re.M)
    out = load_tool("run_defrag_smoke_torch").run(seed, emit=lambda s: None)
    assert out["failure"] is None
    assert out["site"] in got[1] and out["moved"] in got[1]
    assert out["plan"]["outcome"] == "planned"
    assert f"gang on {out['gang']}" in got[1]
    assert (out["lost"], out["failed"]) == (0, 0)
