#!/usr/bin/env python3
"""Fleet soak smoke on the PyTorch port: a full scripted day of diurnal
traffic + chaos against the port's driver/gateway stack, gated.

Twin of ``tools/run_fleet_smoke.py`` (``make fleetsmoke``) over
``k8s_dra_driver_tpu_torch.fleetsim``: the same scenario
(``smoke_scenario(seed)``), seed, gates, gate lines and exit codes. It
imports nothing of JAX. One deterministic discrete-event run drives the
port's gateway admission/routing/autoscaling, the plugin loop (health
transitions, elastic resize, rebalancer, defrag execution, state
auditor) and the reference allocator through the five acceptance axes
on one virtual clock: diurnal load per tenant class, a shared-prefix
flash crowd, chip chaos (a flapping free chip, a serving-chip unplug, a
training-chip unplug), an apiserver blackout window, and a 2-chip gang
stranded by fragmentation until the defrag executor frees a box.

PASS requires every gate in the report: zero admitted loss (typed
classification -- lost/unclassified/expired all zero), auditor silence
at every tick, the stranded gang admitted via an executed plan,
per-class TTFT/e2e p99 within budget, autoscaler efficiency at or
above the oracle floor, and zero rebalancer below-min seconds.

``FLEET_r01.json`` is the reference's record, never this tool's: the
report is written only to an explicit ``--out`` (the reference's
artifact format, ``fleetsim.write_artifact``), and its first line says
``ran`` where the reference's says ``wrote <artifact>``.

Exit 0 on PASS, 1 on any violated gate. TPU_DRA_CHAOS_SEED overrides
the seed (default 1234). Run from the repo root:
``python tools/run_fleet_smoke_torch.py [--out PATH]``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = int(os.environ.get("TPU_DRA_CHAOS_SEED", "1234"))


def run(seed: int = SEED) -> dict:
    """The soak's report (deterministic for a seed), its spec's virtual
    duration, its wall seconds, and the names of the failed gates."""
    from k8s_dra_driver_tpu_torch.fleetsim import FleetSim, smoke_scenario

    spec = smoke_scenario(seed=seed)
    t0 = time.time()
    report = FleetSim(spec).run()
    wall_s = time.time() - t0
    failed = [g for g, v in sorted(report["gates"].items())
              if not v["pass"]]
    return dict(report=report, duration_s=spec.duration_s, t0=t0,
                wall_s=wall_s, failed=failed)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--out", default="",
        help="write the report here (default: print the gates only)")
    args = parser.parse_args(argv)
    out = run(SEED)
    report, wall_s = out["report"], out["wall_s"]
    if args.out:
        from k8s_dra_driver_tpu_torch.fleetsim import write_artifact

        write_artifact(report, args.out, wall_clock={
            "generatedAt": round(out["t0"], 3),
            "runSeconds": round(wall_s, 3),
        })
        print(f"wrote {args.out} ({wall_s:.1f}s wall for "
              f"{out['duration_s']:.0f} virtual seconds)")
    else:
        print(f"ran ({wall_s:.1f}s wall for {out['duration_s']:.0f} "
              f"virtual seconds)")

    for g, v in sorted(report["gates"].items()):
        status = "ok" if v["pass"] else "FAIL"
        print(f"  gate {g}: {status} value={json.dumps(v['value'])} "
              f"budget={json.dumps(v['budget'])}")
    if out["failed"]:
        print(f"FAIL: gates violated: {', '.join(out['failed'])}")
        return 1
    if not report["pass"]:
        print("FAIL: report['pass'] is false with no failed gate "
              "(gate accounting drift)")
        return 1

    loss = report["loss"]
    print(
        f"PASS: seed={SEED} {loss['submitted']} requests "
        f"({loss['served']} served, {loss.get('retried', 0)} retried, "
        f"{loss['shed-watermark']} shed), "
        f"{report['chaos']['failovers']} failovers, "
        f"{report['audit']['passes']} silent audit passes, "
        f"gang on {report['defrag']['gangDevices']}, "
        f"efficiency {report['autoscaler']['efficiency']}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
