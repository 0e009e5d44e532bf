"""Node-state inspection: the operator's view of one plugin's world.

The role nvidia-smi plays when debugging the reference driver — except
this driver's runtime state is plain files, so the inspector needs no
hardware library: it reads the checkpoint (prepared claims), the durable
sharing state, the CDI specs on disk, and (optionally) the live chip
inventory, and prints one coherent summary. Read-only by construction.

    python -m k8s_dra_driver_tpu_torch.plugin.inspect \
        --state-root /var/lib/tpu-dra --cdi-root /var/run/cdi

``--json`` emits the same structure machine-readably (for support
bundles / bug reports).

The port's copy of the reference module; ``--probe-chips`` reads the
host's GPUs through NVML (``tpulib.chiplib.RealChipLib``), and a GPU in
MIG mode lists its MIG devices with their profiles and placements.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Optional

from ..plugin.checkpoint import CheckpointManager
from ..plugin.prepared import PreparedClaim
from ..plugin.sharing import CorruptShareStateError, SharingStateStore
from ..tpulib.deviceinfo import MigDeviceInfo


def collect_live(http_url: str, timeout: float = 3.0) -> dict[str, Any]:
    """Live-process state no file can show: the degraded-mode flag and
    whether slice republishes are queued behind backoff. Scraped from a
    running plugin's ``/readyz`` (a 503 body is still a diagnosis, not a
    failure). Errors are reported in-band — the inspector must stay
    useful against a dead plugin."""
    import urllib.request

    out: dict[str, Any] = {"url": http_url}
    try:
        with urllib.request.urlopen(
            http_url.rstrip("/") + "/readyz", timeout=timeout
        ) as resp:
            body = resp.read().decode()
    except Exception as e:
        # Only the documented not-ready answer (503) carries a readiness
        # body; a proxy's 502 page is a failure, not a diagnosis.
        body = (getattr(e, "read", lambda: b"")()
                if getattr(e, "code", None) == 503 else b"")
        if body:
            body = body.decode(errors="replace")
        else:
            out["error"] = f"/readyz unreachable: {e}"
            return out
    lines = [ln for ln in body.splitlines() if ln]
    mode = lines[-1] if lines else "unknown"
    out["mode"] = mode
    out["degraded"] = mode == "degraded"
    out["checks"] = lines[:-1]
    # A failing apiserver-reachable check whose detail names the slice
    # republish means inventory/health changes are queued behind backoff
    # (resourceslice.py sync_health wording), not lost.
    queued = next(
        (ln for ln in lines
         if "apiserver-reachable" in ln and not ln.startswith("[+]")
         and "republish" in ln),
        "",
    )
    out["queuedSliceRepublish"] = bool(queued)
    if queued:
        out["queuedSliceRepublishDetail"] = queued
    out.update(_collect_unsat_allocations(http_url, timeout))
    out.update(_collect_defrag_plans(http_url, timeout))
    out.update(_collect_rebalance(http_url, timeout))
    out.update(_collect_gateway(http_url, timeout))
    out.update(_collect_residency(http_url, timeout))
    out.update(_collect_compute(http_url, timeout))
    out.update(_collect_requests(http_url, timeout))
    return out


def _fetch_debug(
    http_url: str, path: str, timeout: float
) -> tuple[Optional[str], Optional[str]]:
    """One debug-endpoint scrape as ``(body, error)``: a 404 yields
    ``(None, None)`` — the surface simply isn't wired on this process,
    which is benign — and any OTHER failure yields ``(None, message)``
    for the caller to surface in-band (silence must mean "nothing to
    report", never "couldn't look"). Shared by every live collector so
    the 404-benign/other-loud contract cannot drift per endpoint."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(
            http_url.rstrip("/") + path, timeout=timeout
        ) as resp:
            return resp.read().decode(), None
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None, None
        return None, f"HTTP {e.code}"
    except Exception as e:
        return None, str(e) or type(e).__name__


def _collect_unsat_allocations(
    http_url: str, timeout: float, keep: int = 5
) -> dict[str, Any]:
    """Recent unallocatable solve decisions from ``/debug/allocations``,
    each mapped to its runbook hint — the "why won't my claim schedule?"
    answer, live (same 404/failure split as doctor.collect_node)."""
    text, err = _fetch_debug(http_url, "/debug/allocations", timeout)
    if err is not None:
        return {"unsatAllocationsError": err}
    if text is None:
        return {}
    from ..kube.allocator import RUNBOOK_HINTS

    unsat = []
    for line in text.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if not isinstance(rec, dict) or rec.get("outcome") == "ok":
            continue
        claim = rec.get("claim") or {}
        reason = rec.get("reason") or "?"
        unsat.append({
            "claim": f"{claim.get('namespace', '?')}/"
                     f"{claim.get('name', '?')}",
            "uid": claim.get("uid", ""),
            "reason": reason,
            "detail": rec.get("detail", ""),
            "hint": RUNBOOK_HINTS.get(reason, ""),
        })
    return {"unsatAllocations": unsat[-keep:]} if unsat else {}


def _collect_defrag_plans(
    http_url: str, timeout: float, keep: int = 3
) -> dict[str, Any]:
    """Recent defrag plans from ``/debug/defrag`` — the actionable half
    of a ``gang``/``shortfall`` unsat."""
    text, err = _fetch_debug(http_url, "/debug/defrag", timeout)
    if err is not None:
        return {"defragPlansError": err}
    if text is None:
        return {}
    try:
        doc = json.loads(text)
    except ValueError as e:
        return {"defragPlansError": str(e)}
    plans = [
        {
            "claim": f"{(p.get('claim') or {}).get('namespace', '?')}/"
                     f"{(p.get('claim') or {}).get('name', '?')}",
            "planId": p.get("planId", ""),
            "outcome": p.get("outcome", "?"),
            "migrations": len(p.get("migrations") or []),
            "detail": p.get("detail", ""),
        }
        for p in (doc.get("plans") or []) if isinstance(p, dict)
    ]
    out: dict[str, Any] = {"defragPlans": plans[-keep:]} if plans else {}
    # The plan→execution trail (present once an executor is attached):
    # per-step outcomes and rollbacks, compressed to one row each.
    execs = [
        {
            "planId": e.get("planId", ""),
            "claim": f"{(e.get('claim') or {}).get('namespace', '?')}/"
                     f"{(e.get('claim') or {}).get('name', '?')}",
            "state": e.get("state", "?"),
            "steps": ", ".join(
                f"{s.get('kind')}={s.get('outcome')}"
                for s in (e.get("steps") or [])
            ),
            "rollbacks": len(e.get("rollbacks") or []),
            "detail": e.get("detail", ""),
        }
        for e in (doc.get("executions") or []) if isinstance(e, dict)
    ]
    if execs:
        out["defragExecutions"] = execs[-keep:]
    return out


def _collect_rebalance(
    http_url: str, timeout: float, keep: int = 5
) -> dict[str, Any]:
    """Recent dynamic-sharing decisions + per-claim granted-vs-declared
    shares from ``/debug/rebalance``."""
    text, err = _fetch_debug(http_url, "/debug/rebalance", timeout)
    if err is not None:
        return {"rebalanceError": err}
    if text is None:
        return {}
    try:
        doc = json.loads(text)
    except ValueError as e:
        return {"rebalanceError": str(e)}
    out: dict[str, Any] = {}
    decisions = [
        {
            "outcome": d.get("outcome", "?"),
            "action": d.get("action", "?"),
            "resource": d.get("resource", "?"),
            "gainer": (d.get("gainer") or {}).get("claim", "?"),
            "donor": (d.get("donor") or {}).get("claim", "?"),
            "shares": (
                f"{(d.get('donor') or {}).get('from')}->"
                f"{(d.get('donor') or {}).get('to')} / "
                f"{(d.get('gainer') or {}).get('from')}->"
                f"{(d.get('gainer') or {}).get('to')}"
            ),
        }
        for d in (doc.get("decisions") or []) if isinstance(d, dict)
    ]
    if decisions:
        out["rebalanceDecisions"] = decisions[-keep:]
    claims = {
        uid: {
            "claim": f"{c.get('namespace', '?')}/{c.get('name', '?')}",
            "latencyClass": c.get("latencyClass", "?"),
            "granted": c.get("granted"),
            "min": c.get("min"),
            "burst": c.get("burst"),
            "belowMinSeconds": c.get("belowMinSeconds", 0.0),
            "graceSeconds": c.get("graceSeconds"),
            "generation": c.get("generation"),
        }
        for uid, c in sorted((doc.get("claims") or {}).items())
        if isinstance(c, dict)
    }
    if claims:
        out["rebalanceClaims"] = claims
    return out


def _collect_gateway(
    http_url: str, timeout: float, keep: int = 5
) -> dict[str, Any]:
    """Fleet-gateway view from ``/debug/gateway``: per-replica state +
    queue depths, the overloaded marker, and recent scale/drain
    events."""
    text, err = _fetch_debug(http_url, "/debug/gateway", timeout)
    if err is not None:
        return {"gatewayError": err}
    if text is None:
        return {}
    try:
        doc = json.loads(text)
    except ValueError as e:
        return {"gatewayError": str(e)}
    out: dict[str, Any] = {
        "gatewayReplicas": {
            rid: {
                "state": r.get("state", "?"),
                "queueDepth": r.get("queueDepth", 0),
                "claimUid": r.get("claimUid", ""),
            }
            for rid, r in sorted((doc.get("replicas") or {}).items())
            if isinstance(r, dict)
        },
        "gatewayQueues": doc.get("queues") or {},
        "gatewayOverloaded": bool(doc.get("overloaded")),
        "gatewayCounters": doc.get("counters") or {},
    }
    events = [
        e for e in (doc.get("events") or [])
        if isinstance(e, dict)
        and e.get("kind") in ("scale", "drain", "replica-lost")
    ]
    if events:
        out["gatewayEvents"] = events[-keep:]
    return out


def _collect_residency(
    http_url: str, timeout: float
) -> dict[str, Any]:
    """Measured KV residency from ``/debug/residency``: the fleet's
    measured hit rate and duplication ratio plus each replica's
    predicted-vs-measured ledger divergence."""
    text, err = _fetch_debug(http_url, "/debug/residency", timeout)
    if err is not None:
        return {"residencyError": err}
    if text is None:
        return {}
    try:
        doc = json.loads(text)
    except ValueError as e:
        return {"residencyError": str(e)}
    return {
        "residencyFleet": doc.get("fleet") or {},
        "residencyReplicas": {
            rid: {
                "indexedBlocks": r.get("indexedBlocks", 0),
                "evictedBlocks": r.get("evictedBlocks", 0),
                "counterDrift": bool(r.get("counterDrift")),
                "staleKeys": (r.get("ledger") or {}).get("staleKeys", 0),
                "divergence": (r.get("ledger") or {}).get(
                    "divergence", 0.0
                ),
            }
            for rid, r in sorted((doc.get("replicas") or {}).items())
            if isinstance(r, dict)
        },
    }


def _collect_compute(
    http_url: str, timeout: float
) -> dict[str, Any]:
    """Compute-plane summary from ``/debug/compute``: per-program MFU
    and bound classification, recompiles since the warmup horizon, and
    the per-replica HBM decomposition."""
    text, err = _fetch_debug(http_url, "/debug/compute", timeout)
    if err is not None:
        return {"computeError": err}
    if text is None:
        return {}
    try:
        doc = json.loads(text)
    except ValueError as e:
        return {"computeError": str(e)}
    return {
        "computeDevice": doc.get("device") or {},
        "computeWarm": bool(doc.get("warm")),
        "computeBuilds": doc.get("builds") or {},
        "computeRecompiles": doc.get("recompilesSinceWarm") or {},
        "computePrograms": {
            program: {
                rid: {
                    "mfu": roof.get("mfu"),
                    "boundBy": roof.get("boundBy", "?"),
                    "steps": roof.get("steps", 0),
                }
                for rid, roof in sorted(replicas.items())
                if isinstance(roof, dict)
            }
            for program, replicas in sorted(
                (doc.get("programs") or {}).items()
            )
            if isinstance(replicas, dict)
        },
        "computeHbm": {
            rid: {
                "weightsBytes": h.get("weightsBytes", 0),
                "kvPoolBytes": h.get("kvPoolBytes", 0),
                "kvUsedBytes": h.get("kvUsedBytes", 0),
                "watermarkBytes": h.get("watermarkBytes", 0),
                "totalBytes": h.get("totalBytes", 0),
            }
            for rid, h in sorted((doc.get("hbm") or {}).items())
            if isinstance(h, dict)
        },
    }


def _collect_requests(
    http_url: str, timeout: float, keep: int = 3
) -> dict[str, Any]:
    """Request-observability view from ``/debug/requests``: the per-class
    SLO summary plus the most recent violation exemplars — the live "why
    was this request slow?" answer (dominant phase -> runbook row)."""
    text, err = _fetch_debug(http_url, "/debug/requests?view=slo", timeout)
    if err is not None:
        return {"requestsError": err}
    if text is None:
        return {}
    out: dict[str, Any] = {}
    try:
        summary = json.loads(text)
    except ValueError as e:
        return {"requestsError": str(e)}
    if isinstance(summary, dict):
        out["sloSummary"] = summary
    text, err = _fetch_debug(
        http_url, "/debug/requests?view=exemplars", timeout
    )
    if err is not None:
        out["requestsError"] = err
        return out
    exemplars = []
    for line in (text or "").splitlines():
        try:
            ex = json.loads(line)
        except ValueError:
            continue
        if not isinstance(ex, dict):
            continue
        exemplars.append({
            "latencyClass": ex.get("latencyClass", "?"),
            "signal": ex.get("signal", "?"),
            "observedS": ex.get("observedS"),
            "thresholdS": ex.get("thresholdS"),
            "dominantPhase": ex.get("dominantPhase", "?"),
            "traceId": ex.get("traceId", ""),
        })
    if exemplars:
        out["sloExemplars"] = exemplars[-keep:]
    return out


def collect(
    state_root: str,
    cdi_root: str,
    chiplib=None,
    driver_name: str = "tpu.google.com",
    http_url: str = "",
) -> dict[str, Any]:
    """Gather the node's driver state into one structure (pure reads)."""
    out: dict[str, Any] = {"stateRoot": state_root, "cdiRoot": cdi_root}

    # Prepared claims from the checkpoint. A corrupt checkpoint is the
    # crash artifact this tool exists to diagnose — report it and keep
    # going (the sharing and CDI sections may still be readable).
    ckpt_path = os.path.join(state_root, "checkpoint.json")
    claims: list[dict[str, Any]] = []
    try:
        records = CheckpointManager(ckpt_path).read().items()
    except FileNotFoundError:
        records = []
    except Exception as e:  # checksum mismatch, truncation, bad JSON
        records = []
        out["checkpointError"] = f"{type(e).__name__}: {e}"
    for uid, rec in records:
        try:
            pc = PreparedClaim.from_dict(rec)
        except Exception as e:
            claims.append({"uid": uid, "error": f"malformed record: {e}"})
            continue
        claims.append({
            "uid": uid,
            "name": pc.name,
            "namespace": pc.namespace,
            "groups": [
                {
                    "strategy": (
                        "adminAccess"
                        if g.config.get("adminAccess")
                        else (g.config.get("sharing") or {}).get(
                            "strategy", ""
                        ) or g.config.get("kind", "")
                    ),
                    "devices": [d.name for d in g.devices],
                }
                for g in pc.groups
            ],
        })
    out["preparedClaims"] = claims

    # Durable sharing state.
    share_dir = os.path.join(state_root, "state", "sharing")
    shares = []
    if os.path.isdir(share_dir):
        store = SharingStateStore(share_dir)
        for uuid in store.list_chips():
            try:
                st = store.get(uuid)
            except CorruptShareStateError:
                shares.append({"chip": uuid, "error": "CORRUPT"})
                continue
            if st.claims:
                shares.append({
                    "chip": uuid,
                    "mode": st.mode,
                    "claims": sorted(st.claims),
                })
    out["sharingState"] = shares

    # CDI specs on disk, cross-checked against the checkpoint.
    prepared_uids = {c["uid"] for c in claims}
    cdi = {"baseSpec": False, "claimSpecs": [], "orphanedClaimSpecs": []}
    if os.path.isdir(cdi_root):
        from ..cdi.spec import CDIHandler

        handler = CDIHandler(cdi_root, driver_name=driver_name)
        cdi["baseSpec"] = handler.base_spec_exists()
        for uid in handler.list_claim_spec_uids():
            cdi["claimSpecs"].append(uid)
            if uid not in prepared_uids:
                cdi["orphanedClaimSpecs"].append(uid)
    out["cdi"] = cdi

    # Live inventory + health, when a chip library is given (real probing
    # needs a TPU host; the fake serves tests and demos). One snapshot()
    # probe yields both, so a chip can never list present while the same
    # collection reports it gone.
    if chiplib is not None:
        chiplib.init()
        chips, health = chiplib.snapshot()
        out["inventory"] = [
            {
                "name": c.canonical_name(),
                "uuid": c.uuid,
                "generation": c.generation,
                "coord": str(c.coord),
                "sliceId": c.slice_id,
                "health": (
                    health[c.uuid].state if c.uuid in health else "healthy"
                ),
                "healthSince": (
                    health[c.uuid].since if c.uuid in health else 0.0
                ),
                "healthReason": (
                    health[c.uuid].reason if c.uuid in health else ""
                ),
            }
            for c in chips
        ]
        # A GPU in MIG mode is published as its MIG devices, each with
        # its profile and placement (start:size in memory slices).
        migs = [
            tc for c in chips for tc in chiplib.enumerate_core_partitions(c)
            if isinstance(tc, MigDeviceInfo)
        ]
        if migs:
            out["migDevices"] = [
                {
                    "name": m.canonical_name(),
                    "uuid": m.uuid,
                    "parent": m.parent.canonical_name(),
                    "profile": m.profile.name,
                    "placement": f"{m.core_index}:{m.profile.memory_slices}",
                    "gpuInstance": m.gi_id,
                    "computeInstance": m.ci_id,
                }
                for m in migs
            ]
        # Gone chips are absent from the enumeration but their health
        # record is the evidence an operator is looking for.
        out["unhealthyChips"] = [
            {
                "uuid": uuid,
                "state": st.state,
                "since": st.since,
                "reason": st.reason,
            }
            for uuid, st in sorted(health.items())
            if not st.is_healthy()
        ]

    # Live plugin state (degraded mode, queued republishes) — only a
    # running process can answer these; opt-in via --http-url.
    if http_url:
        out["live"] = collect_live(http_url)
    return out


def render(state: dict[str, Any]) -> str:
    lines = [f"tpu-dra node state ({state['stateRoot']})", ""]
    if "checkpointError" in state:
        lines.append(f"CHECKPOINT CORRUPT: {state['checkpointError']}")
        lines.append("")
    claims = state["preparedClaims"]
    lines.append(f"prepared claims: {len(claims)}")
    for c in claims:
        if "error" in c:
            lines.append(f"  {c['uid']}: {c['error']}")
            continue
        for g in c["groups"]:
            lines.append(
                f"  {c['namespace']}/{c['name']} ({c['uid']}): "
                f"{','.join(g['devices'])} [{g['strategy'] or 'Exclusive'}]"
            )
    lines.append("")
    shares = state["sharingState"]
    lines.append(f"chips with sharing holds: {len(shares)}")
    for s in shares:
        if "error" in s:
            lines.append(f"  {s['chip']}: {s['error']}")
        else:
            lines.append(
                f"  {s['chip']}: {s['mode']} by {','.join(s['claims'])}"
            )
    lines.append("")
    cdi = state["cdi"]
    lines.append(
        f"cdi: base spec {'present' if cdi['baseSpec'] else 'MISSING'}, "
        f"{len(cdi['claimSpecs'])} claim specs"
        + (
            f", ORPHANED: {','.join(cdi['orphanedClaimSpecs'])}"
            if cdi["orphanedClaimSpecs"] else ""
        )
    )
    if "inventory" in state:
        lines.append("")
        lines.append(f"chips visible: {len(state['inventory'])}")
        for c in state["inventory"]:
            health = c.get("health", "healthy")
            suffix = ""
            if health != "healthy":
                suffix = (
                    f" [{health.upper()} since {c.get('healthSince', 0):.0f}"
                    + (f": {c['healthReason']}" if c.get("healthReason")
                       else "")
                    + "]"
                )
            lines.append(
                f"  {c['name']} {c['uuid']} {c['generation']} "
                f"coord={c['coord']} slice={c['sliceId']}{suffix}"
            )
        migs = state.get("migDevices") or []
        if migs:
            lines.append("")
            lines.append(f"MIG devices: {len(migs)}")
            for m in migs:
                lines.append(
                    f"  {m['name']} {m['uuid']} on {m['parent']} "
                    f"profile={m['profile']} placement={m['placement']} "
                    f"gi={m['gpuInstance']} ci={m['computeInstance']}"
                )
        unhealthy = state.get("unhealthyChips") or []
        if unhealthy:
            lines.append("")
            lines.append(f"unhealthy chips: {len(unhealthy)}")
            for u in unhealthy:
                lines.append(
                    f"  {u['uuid']}: {u['state']} since "
                    f"{u['since']:.0f}"
                    + (f" ({u['reason']})" if u.get("reason") else "")
                )
    live = state.get("live")
    if live is not None:
        lines.append("")
        if "error" in live:
            lines.append(f"live plugin: UNREACHABLE ({live['error']})")
        else:
            # The cause lives in the [~]-marked check lines below (an
            # apiserver outage reads differently from state drift); the
            # headline only states the mode.
            lines.append(
                f"live plugin: {live.get('mode', 'unknown')}"
                + (" — DEGRADED MODE (still serving; the [~] checks "
                   "below name the cause)" if live.get("degraded")
                   else "")
            )
            if live.get("queuedSliceRepublish"):
                lines.append(
                    "  slice republishes QUEUED behind backoff: "
                    + live.get("queuedSliceRepublishDetail", "")
                )
            for check in live.get("checks", []):
                lines.append(f"  {check}")
            if live.get("unsatAllocationsError"):
                lines.append(
                    "  /debug/allocations scrape FAILED "
                    f"({live['unsatAllocationsError']}) — unallocatable-"
                    "claim view unavailable, NOT known-empty"
                )
            unsat = live.get("unsatAllocations") or []
            if unsat:
                lines.append("")
                lines.append(
                    f"recent unallocatable claims: {len(unsat)}"
                )
                for u in unsat:
                    lines.append(
                        f"  {u['claim']}: {u['reason']} — "
                        f"{u.get('detail') or 'no detail'}"
                    )
                    if u.get("hint"):
                        lines.append(f"    runbook: {u['hint']}")
            if live.get("defragPlansError"):
                lines.append(
                    "  /debug/defrag scrape FAILED "
                    f"({live['defragPlansError']}) — defrag-plan view "
                    "unavailable, NOT known-empty"
                )
            plans = live.get("defragPlans") or []
            if plans:
                lines.append("")
                lines.append(f"recent defrag plans: {len(plans)}")
                for p in plans:
                    lines.append(
                        f"  {p.get('planId') or '?'} {p['claim']}: "
                        f"{p['outcome']} "
                        f"({p['migrations']} migration(s)) — "
                        f"{p.get('detail') or 'no detail'}"
                    )
            execs = live.get("defragExecutions") or []
            if execs:
                lines.append("")
                lines.append(f"defrag executions: {len(execs)}")
                for e in execs:
                    lines.append(
                        f"  {e.get('planId') or '?'} {e['claim']}: "
                        f"{e['state']} — "
                        f"{e.get('steps') or 'no steps recorded'}"
                        + (
                            f" ({e['rollbacks']} rollback(s))"
                            if e.get("rollbacks") else ""
                        )
                    )
                    if e.get("detail"):
                        lines.append(f"    {e['detail']}")
            if live.get("rebalanceError"):
                lines.append(
                    "  /debug/rebalance scrape FAILED "
                    f"({live['rebalanceError']}) — SLO/share view "
                    "unavailable, NOT known-clean"
                )
            shares = live.get("rebalanceClaims") or {}
            if shares:
                lines.append("")
                lines.append(
                    f"dynamic-sharing claims: {len(shares)}"
                )
                for uid, c in shares.items():
                    granted = c.get("granted") or {}
                    mins = c.get("min") or {}
                    starving = (
                        (c.get("graceSeconds") is not None
                         and (c.get("belowMinSeconds") or 0)
                         > c["graceSeconds"])
                    )
                    lines.append(
                        f"  {c['claim']} ({uid}): granted "
                        f"tc={granted.get('tensorcore')}% "
                        f"hbm={granted.get('hbm')}% vs min "
                        f"tc={mins.get('tensorcore')}% "
                        f"hbm={mins.get('hbm')}% "
                        f"[{c.get('latencyClass')}, gen "
                        f"{c.get('generation')}]"
                        + (" SLO-STARVED" if starving else "")
                    )
            decisions = live.get("rebalanceDecisions") or []
            if decisions:
                lines.append("")
                lines.append(
                    f"recent rebalance decisions: {len(decisions)}"
                )
                for d in decisions:
                    lines.append(
                        f"  {d['outcome']} {d['action']} "
                        f"{d['resource']}: {d['donor']} -> "
                        f"{d['gainer']} ({d['shares']})"
                    )
            if live.get("gatewayError"):
                lines.append(
                    "  /debug/gateway scrape FAILED "
                    f"({live['gatewayError']}) — fleet-gateway view "
                    "unavailable, NOT known-healthy"
                )
            gw_replicas = live.get("gatewayReplicas") or {}
            if gw_replicas:
                lines.append("")
                counters = live.get("gatewayCounters") or {}
                lines.append(
                    f"serving gateway: {len(gw_replicas)} replica(s), "
                    f"queues {live.get('gatewayQueues') or {}}, "
                    f"routed {counters.get('routed', 0)}, shed "
                    f"{counters.get('shed', 0)}, affinity hit rate "
                    f"{counters.get('affinityHitRate', 0)}"
                    + (" OVERLOADED"
                       if live.get("gatewayOverloaded") else "")
                )
                for rid, r in gw_replicas.items():
                    lines.append(
                        f"  {rid}: {r['state']}, queue depth "
                        f"{r['queueDepth']}"
                        + (f" (claim {r['claimUid']})"
                           if r.get("claimUid") else "")
                    )
                for e in live.get("gatewayEvents") or []:
                    lines.append(
                        f"  event: {e.get('kind')} "
                        + " ".join(
                            f"{k}={v}" for k, v in sorted(e.items())
                            if k not in ("kind", "ts", "tick")
                        )
                    )
            if live.get("residencyError"):
                lines.append(
                    "  /debug/residency scrape FAILED "
                    f"({live['residencyError']}) — measured KV "
                    "residency view unavailable, NOT known-healthy"
                )
            res_fleet = live.get("residencyFleet") or {}
            if res_fleet:
                lines.append("")
                lines.append(
                    "measured KV residency: fleet hit rate "
                    f"{res_fleet.get('measuredHitRate', 0)} "
                    f"({res_fleet.get('hits', 0)}/"
                    f"{res_fleet.get('lookups', 0)}), "
                    f"{res_fleet.get('uniqueKeys', 0)} unique prefix "
                    "key(s), duplication ratio "
                    f"{res_fleet.get('duplicationRatio', 1.0)}"
                )
                for rid, r in (
                    live.get("residencyReplicas") or {}
                ).items():
                    lines.append(
                        f"  {rid}: {r['indexedBlocks']} indexed, "
                        f"{r['evictedBlocks']} evicted, "
                        f"{r['staleKeys']} stale ledger key(s) "
                        f"(divergence {r['divergence']})"
                        + (" COUNTER-DRIFT" if r["counterDrift"] else "")
                    )
            if live.get("computeError"):
                lines.append(
                    "  /debug/compute scrape FAILED "
                    f"({live['computeError']}) — compute-plane view "
                    "unavailable, NOT known-healthy"
                )
            if live.get("computePrograms") or live.get("computeHbm"):
                dev = live.get("computeDevice") or {}
                recompiles = live.get("computeRecompiles") or {}
                total_recompiles = sum(recompiles.values())
                lines.append("")
                lines.append(
                    f"compute plane ({dev.get('kind', '?')}): "
                    f"{sum((live.get('computeBuilds') or {}).values())} "
                    "program build(s), "
                    + (
                        f"{total_recompiles} recompile(s) since warmup"
                        + (
                            " RECOMPILE-STORM"
                            if live.get("computeWarm")
                            and total_recompiles else ""
                        )
                        if live.get("computeWarm")
                        else "warmup horizon not marked"
                    )
                )
                for program, replicas in (
                    live.get("computePrograms") or {}
                ).items():
                    for rid, roof in replicas.items():
                        mfu = roof.get("mfu")
                        lines.append(
                            f"  {program}@{rid}: mfu "
                            + (f"{mfu:.4f}" if mfu is not None else "?")
                            + f", {roof['boundBy']}-bound over "
                            f"{roof['steps']} step(s)"
                        )
                for rid, hbm in (live.get("computeHbm") or {}).items():
                    lines.append(
                        f"  hbm@{rid}: {hbm['totalBytes']} B total = "
                        f"{hbm['weightsBytes']} weights + "
                        f"{hbm['kvPoolBytes']} kv pool "
                        f"({hbm['kvUsedBytes']} used), watermark "
                        f"{hbm['watermarkBytes']}"
                    )
            if live.get("requestsError"):
                lines.append(
                    "  /debug/requests scrape FAILED "
                    f"({live['requestsError']}) — request SLO view "
                    "unavailable, NOT known-healthy"
                )
            slo = live.get("sloSummary") or {}
            if slo:
                lines.append("")
                lines.append(
                    f"request SLOs: {slo.get('requests', 0)} request(s), "
                    f"{slo.get('violations', 0)} violation(s), "
                    f"{slo.get('sheds', 0)} shed, affinity hit rate "
                    f"{slo.get('affinityHitRate', 0)}"
                )
                for cls, stats in sorted(
                    (slo.get("classes") or {}).items()
                ):
                    if not isinstance(stats, dict):
                        continue
                    lines.append(
                        f"  {cls}: ttft p99 {stats.get('ttftP99S')}s, "
                        f"e2e p99 {stats.get('e2eP99S')}s, "
                        f"{stats.get('violations', 0)} violation(s)"
                    )
                for ex in live.get("sloExemplars") or []:
                    lines.append(
                        f"  exemplar: {ex['latencyClass']} {ex['signal']} "
                        f"{ex['observedS']}s > {ex['thresholdS']}s, "
                        f"dominant phase {ex['dominantPhase']} "
                        f"(trace {ex['traceId'] or '?'}) — see the "
                        "\"why was this request slow?\" runbook in "
                        "docs/operations.md"
                    )
    return "\n".join(lines)


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Inspect a tpu-dra node's driver state (read-only)."
    )
    p.add_argument("--state-root", default="/var/lib/tpu-dra")
    p.add_argument("--cdi-root", default="/var/run/cdi")
    p.add_argument("--driver-name", default="tpu.google.com")
    p.add_argument("--fake-topology", default="",
                   help="inspect with a fake chip inventory (tests/demos)")
    p.add_argument("--probe-chips", action="store_true",
                   help="probe the real /dev + sysfs chip inventory")
    p.add_argument("--http-url", default="",
                   help="a running plugin's debug endpoint (e.g. "
                        "http://localhost:8081) for live state: degraded "
                        "mode, queued slice republishes, readiness checks")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    chiplib = None
    if args.fake_topology:
        from ..tpulib import FakeChipLib

        chiplib = FakeChipLib(topology=args.fake_topology)
    elif args.probe_chips:
        from ..tpulib.chiplib import RealChipLib

        chiplib = RealChipLib()

    state = collect(
        args.state_root, args.cdi_root, chiplib, args.driver_name,
        http_url=args.http_url,
    )
    if args.json:
        print(json.dumps(state, indent=2))
    else:
        print(render(state))
    return 0


if __name__ == "__main__":
    sys.exit(main())
