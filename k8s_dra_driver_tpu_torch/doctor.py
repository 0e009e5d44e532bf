"""tpu-dra doctor: fleet-wide diagnosis + support bundles.

The port's copy of the reference module. The node-level surfaces
(/metrics, /debug/traces, /debug/usage and the state-drift auditor)
answer "what does ONE node think"; an operator debugging a fleet needs
the cross-node question: does the cluster's view (ResourceSlices,
ResourceClaims) agree with what every node actually holds — and how busy
is the fleet?

    python -m k8s_dra_driver_tpu_torch.doctor \\
        --node node-a=http://10.0.0.11:8081 \\
        --node node-b=http://10.0.0.12:8081 \\
        --bundle /tmp/tpu-dra-bundle.tar

Per node it scrapes ``/metrics``, ``/debug/usage``, ``/debug/traces``
and ``/readyz``; from the API server it reads ResourceSlices and
ResourceClaims; then it re-runs the audit cross-checks FLEET-wide:

- node-local drift surfaced by each node's auditor
  (``tpu_dra_audit_findings`` > 0);
- claims a node holds whose ResourceClaim no longer exists (or changed
  UID) in the apiserver;
- claims the apiserver says are allocated to a node that the node has
  not prepared (informational — the pod may simply not have started);
- per-claim device-set mismatches between allocation and prepare;
- ICI channel occupancy vs the controller's published pools;
- unsatisfiable allocation decisions surfaced by ``/debug/allocations``
  (the ``explain`` check), each mapped to a runbook hint answering "why
  won't my claim schedule?";
- SLO starvation surfaced by ``/debug/rebalance`` (the ``slo`` check):
  a claim below its declared min share for longer than its latency
  class allows, with the node's recent rebalance decisions bundled as
  the evidence trail;
- fleet-gateway health surfaced by ``/debug/gateway`` (the ``gateway``
  check): a most-recent-FAILED autoscale attempt is drift (the load
  closed loop is broken right now — an old failure a later attempt
  recovered from is not), an overloaded fleet (queue depth past the
  shed watermark) is informational with the playbook pointer, and the
  snapshot is bundled as ``gateway.json``;
- measured KV residency surfaced by ``/debug/residency`` (the
  ``kv-residency`` check): a replica whose measured digest violates its
  own lifecycle counters (``indexedBlocks != insertedBlocks -
  evictedBlocks`` — it claims residency for blocks its eviction
  counters say are gone) is drift; router-ledger keys the measured
  digest no longer holds (evicted-but-ledgered staleness) surface as
  informational with the warm-cache playbook pointer, and the snapshot
  is bundled as ``residency.json``;
- compute-plane trouble surfaced by ``/debug/compute``: a program that
  recompiled after its replica's warmup horizon is drift (the
  ``recompile-storm`` check — on the port a compile is a CUDA-graph
  capture, and every one after warm-up re-pays a capture on the serving
  path), and a program whose measured MFU has fallen below half the best
  ``BENCH_r*.json`` round in ``--bench-dir`` (the ``mfu-regression``
  check; the port's baseline is a card measurement, never the TPU rounds
  committed at the repo's root) is drift — perf regressions surface in a
  support bundle, not just at bench time; the snapshot is bundled as
  ``compute.json``;
- request-level SLO trouble surfaced by ``/debug/requests`` (the
  ``slo-exemplar`` check): a latency class with sustained violations
  in its ``?view=slo`` summary is drift, pointing at the slowest
  captured violation exemplar's dominant timeline phase and the
  matching "why was this request slow?" runbook row in
  docs/operations.md; timelines, exemplars, and the summary are
  bundled as ``requests.json``. A 404 is benign (request tracing is
  opt-in); any other failure is a loud collect error.

``--bundle`` additionally writes a tar of every raw document (metrics,
usage JSON, traces JSONL, readyz, cluster objects, findings) for
offline support. The whole tool is read-only and runs unchanged against
the FakeKubeClient cluster sim (tools/run_doctor_sim_torch.py, the
port's twin of the ``make doctor`` gate), so its checks are exercised
hermetically in CI.

Exit status: 0 clean, 1 drift findings, 2 collection errors.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import logging
import re
import sys
import tarfile
import time
import urllib.request
from typing import Any, Optional

logger = logging.getLogger(__name__)

SEVERITY_DRIFT = "drift"
SEVERITY_INFO = "info"
SEVERITY_ERROR = "error"

# A latency class with at least this many SLO violations in a node's
# /debug/requests?view=slo summary is "sustained" — one-off stragglers
# stay out of the findings, a pattern gets the slo-exemplar diagnosis.
SLO_SUSTAINED_VIOLATIONS = 3

# A program whose measured MFU drops below this fraction of the best
# committed BENCH_r*.json mfu_fraction round is an mfu-regression drift
# finding. Generous on purpose: the doctor flags "half the machine went
# missing", the bench spread tripwire owns the fine-grained trend.
MFU_REGRESSION_RATIO = 0.5


@dataclasses.dataclass(frozen=True)
class DoctorFinding:
    severity: str  # drift | info | error
    check: str
    subject: str
    detail: str

    def __str__(self) -> str:
        return f"{self.severity.upper()} [{self.check}] {self.subject}: {self.detail}"


# ---------------------------------------------------------------------------
# Prometheus text parsing (just enough to read gauges/counters back)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)(?:\s+-?\d+)?$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label(v: str) -> str:
    # One left-to-right pass: sequential str.replace would turn the
    # wire form of a literal backslash-then-n (``\\n``) into a newline.
    out = []
    i = 0
    while i < len(v):
        if v[i] == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(v[i])
            i += 1
    return "".join(out)


def parse_metrics(text: str) -> dict[str, list[tuple[dict, float]]]:
    """name -> [(labels, value), ...] for every sample line."""
    out: dict[str, list[tuple[dict, float]]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, raw_labels, raw_value = m.groups()
        labels = {
            k: _unescape_label(v)
            for k, v in _LABEL_RE.findall(raw_labels or "")
        }
        try:
            value = float(raw_value)
        except ValueError:
            continue
        out.setdefault(name, []).append((labels, value))
    return out


def metric_value(
    metrics: dict, name: str, **labels
) -> Optional[float]:
    for sample_labels, value in metrics.get(name, []):
        if all(sample_labels.get(k) == v for k, v in labels.items()):
            return value
    return None


# ---------------------------------------------------------------------------
# Collection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NodeScrape:
    name: str
    url: str
    metrics_text: str = ""
    metrics: dict = dataclasses.field(default_factory=dict)
    usage: Optional[dict] = None
    traces_text: str = ""
    readyz_text: str = ""
    allocations_text: str = ""
    defrag: Optional[dict] = None
    rebalance: Optional[dict] = None
    gateway: Optional[dict] = None
    residency: Optional[dict] = None
    compute: Optional[dict] = None
    requests_text: str = ""
    slo_summary: Optional[dict] = None
    exemplars: list = dataclasses.field(default_factory=list)
    errors: list = dataclasses.field(default_factory=list)

    @property
    def readiness(self) -> str:
        lines = [ln for ln in self.readyz_text.splitlines() if ln]
        return lines[-1] if lines else "unknown"

    @property
    def holds(self) -> list[dict]:
        return list((self.usage or {}).get("holds") or [])

    @property
    def allocations(self) -> list[dict]:
        """Solve-decision records from /debug/allocations (oldest first).
        Undecodable lines are skipped — a version-skewed record must
        degrade the check, not abort the run."""
        out = []
        for line in self.allocations_text.splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out

    @property
    def timelines(self) -> list[dict]:
        """Sealed request timelines from /debug/requests (oldest
        first), undecodable lines skipped — same degrade-don't-abort
        contract as ``allocations``."""
        out = []
        for line in self.requests_text.splitlines():
            if not line.strip():
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if isinstance(doc, dict):
                out.append(doc)
        return out

    @property
    def pool_name(self) -> str:
        """The node name used for placement checks: the one the plugin
        REPORTS about itself (usage snapshot ``node``, which is its pool
        name) — the operator-supplied ``--node`` label is only a display
        key and may be a nickname. A mismatch is also surfaced as a
        collection error by collect_node."""
        reported = (self.usage or {}).get("node")
        return reported or self.name


def _fetch(url: str, timeout: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def collect_node(name: str, url: str, timeout: float = 5.0) -> NodeScrape:
    scrape = NodeScrape(name=name, url=url.rstrip("/"))
    for attr, path, body_is_diagnosis in (
        ("metrics_text", "/metrics", False),
        ("traces_text", "/debug/traces", False),
        ("readyz_text", "/readyz", True),
    ):
        try:
            setattr(scrape, attr, _fetch(scrape.url + path, timeout))
        except Exception as e:
            # ONLY /readyz answers non-200 as part of normal operation,
            # and only with a 503 (= not ready IS the diagnosis). Any
            # other error body — from /metrics, /debug/traces, or a
            # proxy's 502 page in front of /readyz — is a failure, not
            # data; storing it would silently parse to nothing (or to a
            # nonsense readiness line) and hide the node from every
            # downstream check.
            body = (getattr(e, "read", lambda: b"")()
                    if body_is_diagnosis
                    and getattr(e, "code", None) == 503 else b"")
            if body:
                setattr(scrape, attr, body.decode(errors="replace"))
            else:
                scrape.errors.append(f"{path}: {e}")
    try:
        scrape.usage = json.loads(
            _fetch(scrape.url + "/debug/usage", timeout)
        )
    except Exception as e:
        scrape.errors.append(f"/debug/usage: {e}")
    try:
        scrape.allocations_text = _fetch(
            scrape.url + "/debug/allocations", timeout
        )
    except Exception as e:
        # 404 = allocation explainability simply not wired on this node
        # (node plugins don't run the allocator; only sim/scheduler
        # processes do) — absence is normal, not a collection error.
        if getattr(e, "code", None) != 404:
            scrape.errors.append(f"/debug/allocations: {e}")
    try:
        scrape.defrag = json.loads(
            _fetch(scrape.url + "/debug/defrag", timeout)
        )
    except Exception as e:
        # Same contract as /debug/allocations: the planner only runs
        # beside an allocator, so a 404 is a normal node plugin.
        if getattr(e, "code", None) != 404:
            scrape.errors.append(f"/debug/defrag: {e}")
    try:
        scrape.rebalance = json.loads(
            _fetch(scrape.url + "/debug/rebalance", timeout)
        )
    except Exception as e:
        # 404 = the dynamic-sharing rebalancer is simply not wired on
        # this process (disabled, or an older plugin) — benign. Any
        # OTHER failure is loud: silence must mean "no SLO trouble",
        # never "couldn't look".
        if getattr(e, "code", None) != 404:
            scrape.errors.append(f"/debug/rebalance: {e}")
    try:
        scrape.gateway = json.loads(
            _fetch(scrape.url + "/debug/gateway", timeout)
        )
    except Exception as e:
        # Same contract again: the serving gateway only runs on fleet
        # frontends, so a 404 is a normal node plugin.
        if getattr(e, "code", None) != 404:
            scrape.errors.append(f"/debug/gateway: {e}")
    try:
        scrape.residency = json.loads(
            _fetch(scrape.url + "/debug/residency", timeout)
        )
    except Exception as e:
        # 404 = no ResidencyIndex on this process (node plugins don't
        # front a fleet) — benign; anything else is loud.
        if getattr(e, "code", None) != 404:
            scrape.errors.append(f"/debug/residency: {e}")
    try:
        scrape.compute = json.loads(
            _fetch(scrape.url + "/debug/compute", timeout)
        )
    except Exception as e:
        # 404 = compute telemetry not attached on this process (it is
        # opt-in, like request tracing) — benign; anything else is loud.
        if getattr(e, "code", None) != 404:
            scrape.errors.append(f"/debug/compute: {e}")
    try:
        scrape.requests_text = _fetch(
            scrape.url + "/debug/requests", timeout
        )
    except Exception as e:
        # 404 = request tracing is simply not enabled on this process
        # (telemetry is opt-in) — benign. Any other failure is loud.
        if getattr(e, "code", None) != 404:
            scrape.errors.append(f"/debug/requests: {e}")
    else:
        # Tracing IS enabled here, so the summary/exemplar views must
        # answer — their failure is always a collect error.
        for path, view in (("/debug/requests?view=slo", "slo"),
                           ("/debug/requests?view=exemplars",
                            "exemplars")):
            try:
                body = _fetch(scrape.url + path, timeout)
                if view == "slo":
                    scrape.slo_summary = json.loads(body)
                else:
                    scrape.exemplars = [
                        json.loads(ln)
                        for ln in body.splitlines() if ln.strip()
                    ]
            except Exception as e:
                scrape.errors.append(f"{path}: {e}")
    reported = (scrape.usage or {}).get("node")
    if reported and reported != name:
        scrape.errors.append(
            f"/debug/usage: node reports its name as {reported!r}, not "
            f"{name!r} — check the --node mapping (placement checks key "
            "on the reported name)"
        )
    scrape.metrics = parse_metrics(scrape.metrics_text)
    return scrape


def collect_cluster(client, driver_name: str) -> dict[str, Any]:
    """ResourceSlices + ResourceClaims in normalized (v1alpha3-shaped)
    form, via the served resource.k8s.io dialect."""
    from .kube.resourceapi import ResourceApi

    api = ResourceApi.discover(client)
    slices = [
        api.slice_from_wire(s) for s in client.list(api.slices)
        if (s.get("spec") or {}).get("driver") == driver_name
    ]
    claims = []
    for c in client.list(api.claims):
        c = api.claim_from_wire(c)
        if _allocation_results(c, driver_name):
            claims.append(c)
    return {"resourceSlices": slices, "resourceClaims": claims}


# ---------------------------------------------------------------------------
# Fleet-wide audit
# ---------------------------------------------------------------------------

def fleet_findings(
    nodes: list[NodeScrape], cluster: Optional[dict], driver_name: str,
    bench_mfu: Optional[float] = None,
) -> list[DoctorFinding]:
    findings: list[DoctorFinding] = []

    for node in nodes:
        for err in node.errors:
            findings.append(DoctorFinding(
                SEVERITY_ERROR, "collect", node.name, err
            ))
        # Node-local drift, as reported by that node's auditor.
        for labels, value in node.metrics.get("tpu_dra_audit_findings", []):
            if value > 0:
                findings.append(DoctorFinding(
                    SEVERITY_DRIFT, "node-audit",
                    f"{node.name}/{labels.get('check', '?')}",
                    f"node auditor reports {int(value)} open drift "
                    f"finding(s)",
                ))
        if node.readiness == "not ready":
            findings.append(DoctorFinding(
                SEVERITY_DRIFT, "readiness", node.name,
                "node /readyz reports not ready",
            ))
        elif node.readiness == "degraded":
            findings.append(DoctorFinding(
                SEVERITY_INFO, "readiness", node.name,
                "node /readyz reports degraded",
            ))
        elif node.readiness != "ready" and not any(
            err.startswith("/readyz") for err in node.errors
        ):
            # Truncated body, version skew — whatever it is, an
            # unrecognized state must not read as healthy. A FAILED
            # /readyz fetch is already a collect error above; a second
            # finding for the same root cause would just inflate triage.
            findings.append(DoctorFinding(
                SEVERITY_ERROR, "readiness", node.name,
                f"unrecognized /readyz state {node.readiness!r}",
            ))
        # SLO starvation, from the rebalancer's own share view
        # (/debug/rebalance): a claim below its declared min share for
        # longer than its latency class allows is a violation the
        # rebalancer could not (or was not allowed to) heal.
        for uid, claim in sorted(
            ((node.rebalance or {}).get("claims") or {}).items()
        ):
            if not isinstance(claim, dict):
                continue
            below = claim.get("belowMinSeconds") or 0
            grace = claim.get("graceSeconds")
            if grace is None or below <= grace:
                continue
            findings.append(DoctorFinding(
                SEVERITY_DRIFT, "slo",
                f"{node.name}/{claim.get('namespace', '?')}/"
                f"{claim.get('name', '?')}",
                f"claim below its declared min share for {below:.0f}s "
                f"(latency class {claim.get('latencyClass', '?')} "
                f"allows {grace:.0f}s) — read the node's "
                "/debug/rebalance decisions: co-tenants pinned at "
                "their own min means the node is oversubscribed; "
                "failed decisions mean the apply path is broken",
            ))
        # Fleet-gateway health (/debug/gateway): a failed autoscale is
        # drift (the closed loop is broken — the fleet cannot react to
        # load); an overloaded-but-scaling fleet is informational with
        # the playbook pointer.
        if node.gateway is not None:
            gw_events = [
                e for e in (node.gateway.get("events") or [])
                if isinstance(e, dict)
            ]
            # Only the MOST RECENT scale attempt drives the verdict: a
            # transient failure that a later attempt recovered from
            # would otherwise sit in the 256-deep ring flagging the
            # node as drift for days. Damped skips (dwell/cooldown/
            # clamped) don't overwrite a standing failure — nothing was
            # retried yet.
            attempts = [
                e for e in gw_events
                if e.get("kind") == "scale"
                and e.get("outcome") in ("applied", "failed")
            ]
            if attempts and attempts[-1].get("outcome") == "failed":
                last = attempts[-1]
                findings.append(DoctorFinding(
                    SEVERITY_DRIFT, "gateway", node.name,
                    f"autoscale {last.get('direction', '?')} FAILED: "
                    f"{last.get('detail') or last.get('reason') or '?'}"
                    " — the fleet cannot react to load; check the "
                    "provisioner's allocator solve (/debug/allocations "
                    "explains an unsat) and the overloaded-fleet "
                    "playbook in docs/operations.md",
                ))
            if node.gateway.get("overloaded"):
                findings.append(DoctorFinding(
                    SEVERITY_INFO, "gateway", node.name,
                    f"fleet queue depth "
                    f"{node.gateway.get('fleetQueueDepth', '?')} is "
                    "past the shed watermark (batch traffic is being "
                    "rejected with retry-after) — see the "
                    "overloaded-fleet playbook in docs/operations.md",
                ))
        # Measured KV residency (/debug/residency): a replica whose
        # digest disagrees with its own lifecycle counters claims
        # residency for blocks its eviction counters say are gone —
        # the measurement substrate itself is broken, which is drift.
        # Evicted-but-ledgered staleness (router predicts warm, engine
        # measures cold) is expected after churn and stays
        # informational, pointing at the warm-cache playbook.
        for rid, rep in sorted(
            ((node.residency or {}).get("replicas") or {}).items()
        ):
            if not isinstance(rep, dict):
                continue
            if rep.get("counterDrift"):
                findings.append(DoctorFinding(
                    SEVERITY_DRIFT, "kv-residency",
                    f"{node.name}/{rid}",
                    f"measured digest holds {rep.get('indexedBlocks')} "
                    f"indexed block(s) but the replica's own lifecycle "
                    f"counters say {rep.get('insertedBlocks')} inserted "
                    f"- {rep.get('evictedBlocks')} evicted — it claims "
                    "residency for blocks its eviction counters say are "
                    "gone; the /debug/kv ledger on that replica is the "
                    "evidence trail",
                ))
            ledger = rep.get("ledger") or {}
            stale = ledger.get("staleKeys") or 0
            if stale > 0:
                findings.append(DoctorFinding(
                    SEVERITY_INFO, "kv-residency",
                    f"{node.name}/{rid}",
                    f"{int(stale)} router-ledger key(s) predicted warm "
                    f"are no longer measured resident (divergence "
                    f"{ledger.get('divergence')}) — eviction outpaced "
                    "affinity; see the \"is my fleet's KV cache "
                    "actually warm?\" playbook in docs/operations.md",
                ))
        # Compute plane (/debug/compute): a program recompiling AFTER
        # the replica's warmup horizon (on the port: a CUDA-graph
        # capture) re-pays it on the serving path — the recompile-storm
        # signal the bench spread tripwire can only infer. And measured
        # MFU far below the bench trajectory means the machine regressed
        # in a way the in-process roofline can already see.
        if node.compute is not None:
            recompiles = node.compute.get("recompilesSinceWarm") or {}
            if node.compute.get("warm"):
                for program, count in sorted(recompiles.items()):
                    if count > 0:
                        findings.append(DoctorFinding(
                            SEVERITY_DRIFT, "recompile-storm",
                            f"{node.name}/{program}",
                            f"{int(count)} recompile(s) of {program!r} "
                            "after the warmup horizon — every one "
                            "re-pays a CUDA-graph capture on the "
                            "serving path; the CompileLedger records in "
                            "compute.json carry the shapes that "
                            "triggered them (see the \"why is my step "
                            "slow?\" runbook in docs/operations.md)",
                        ))
            if bench_mfu is not None and bench_mfu > 0:
                for program, replicas in sorted(
                    (node.compute.get("programs") or {}).items()
                ):
                    if not isinstance(replicas, dict):
                        continue
                    for rid, roof in sorted(replicas.items()):
                        mfu = (roof or {}).get("mfu")
                        if mfu is None or not (roof.get("steps") or 0):
                            continue
                        if mfu < MFU_REGRESSION_RATIO * bench_mfu:
                            findings.append(DoctorFinding(
                                SEVERITY_DRIFT, "mfu-regression",
                                f"{node.name}/{rid}/{program}",
                                f"measured MFU {mfu:.4f} is below "
                                f"{MFU_REGRESSION_RATIO:.0%} of the "
                                f"committed bench trajectory's best "
                                f"({bench_mfu:.4f}) — the roofline "
                                f"classifies this program as "
                                f"{roof.get('boundBy', '?')}-bound; "
                                "see the \"why is my step slow?\" "
                                "runbook in docs/operations.md",
                            ))
        # Request-level SLO trouble (/debug/requests?view=slo): a class
        # with sustained violations gets a finding that already answers
        # "why was this request slow?" — the slowest captured exemplar's
        # dominant timeline phase maps to one operations-playbook row.
        for cls, stats in sorted(
            ((node.slo_summary or {}).get("classes") or {}).items()
        ):
            if not isinstance(stats, dict):
                continue
            violations = stats.get("violations") or 0
            if violations < SLO_SUSTAINED_VIOLATIONS:
                continue
            slowest = None
            for ex in node.exemplars:
                if not isinstance(ex, dict) \
                        or ex.get("latencyClass") != cls:
                    continue
                if slowest is None or (ex.get("observedS") or 0) \
                        > (slowest.get("observedS") or 0):
                    slowest = ex
            detail = (
                f"{int(violations)} {cls} SLO violation(s) "
                f"(e2e p99 {stats.get('e2eP99S', '?')}s, "
                f"ttft p99 {stats.get('ttftP99S', '?')}s)"
            )
            if slowest is not None:
                detail += (
                    f"; slowest exemplar missed its {slowest.get('signal')}"
                    f" budget ({slowest.get('observedS')}s observed vs "
                    f"{slowest.get('thresholdS')}s allowed, trace "
                    f"{slowest.get('traceId') or '?'}) with dominant "
                    f"phase {slowest.get('dominantPhase')!r} — see that "
                    "phase's row in the \"why was this request slow?\" "
                    "runbook in docs/operations.md"
                )
            else:
                detail += (
                    " — no exemplar captured yet; scrape "
                    "/debug/requests?view=exemplars after the next onset"
                )
            findings.append(DoctorFinding(
                SEVERITY_DRIFT, "slo-exemplar",
                f"{node.name}/{cls}", detail,
            ))

    claims_by_uid = {
        (c.get("metadata") or {}).get("uid", ""): c
        for c in (cluster["resourceClaims"] if cluster else [])
    }

    # "Why won't my claim schedule?": unsatisfiable solve decisions from
    # /debug/allocations, mapped to runbook hints. A claim that has since
    # been allocated (it appears in the apiserver WITH an allocation —
    # collect_cluster keeps only those) is stale history, not a finding;
    # without kube access every unsat record is surfaced. Deduped
    # fleet-wide: in the sim, several nodes can serve the same
    # scheduler's decision buffer.
    from .kube.allocator import RUNBOOK_HINTS

    seen_unsat: set[tuple[str, str]] = set()
    for node in nodes:
        latest: dict[str, dict] = {}
        for rec in node.allocations:
            uid = (rec.get("claim") or {}).get("uid") or ""
            latest[uid or f"line-{len(latest)}"] = rec
        for uid, rec in sorted(latest.items()):
            if rec.get("outcome") == "ok":
                continue
            if cluster is not None and uid in claims_by_uid:
                continue  # allocated since this decision was recorded
            reason = rec.get("reason") or "?"
            if (uid, reason) in seen_unsat:
                continue
            seen_unsat.add((uid, reason))
            claim_ref = rec.get("claim") or {}
            subject = (
                f"{claim_ref.get('namespace', '?')}/"
                f"{claim_ref.get('name', '?')}"
            )
            detail = (
                f"unallocatable (terminal reason {reason!r}): "
                f"{rec.get('detail') or 'no detail recorded'}"
            )
            hint = RUNBOOK_HINTS.get(reason)
            if hint:
                detail += f" — runbook: {hint}"
            findings.append(DoctorFinding(
                SEVERITY_DRIFT, "explain", subject, detail,
            ))
            # Defrag cross-check: a gang stuck on FRAGMENTATION (not
            # capacity) whose node has a computed migration plan is
            # actionable — say so next to the unsat finding instead of
            # making the operator correlate two endpoints by hand.
            if reason in ("gang", "shortfall"):
                plan = _defrag_plan_for(nodes, uid)
                if plan is not None and plan.get("outcome") == "planned":
                    findings.append(DoctorFinding(
                        SEVERITY_INFO, "defrag", subject,
                        f"defrag plan available: {plan.get('detail')} — "
                        "see /debug/defrag on the serving node; "
                        "execution reuses the elastic resize protocol",
                    ))

    # Defrag plan→execution trail: every execution record the nodes'
    # /debug/defrag `executions` views carry. A failed execution left
    # the intent on disk (the node auditor's `defrag` check agrees) —
    # DRIFT; an in-flight one is progress — INFO. Completed/rolled-back
    # records are the trail itself and surface only at -v (INFO), so a
    # healthy fleet's doctor run stays quiet but the history is there.
    for node in nodes:
        for rec in (node.defrag or {}).get("executions", []) or []:
            claim_ref = rec.get("claim") or {}
            subject = (
                f"{claim_ref.get('namespace', '?')}/"
                f"{claim_ref.get('name') or claim_ref.get('uid', '?')}"
            )
            steps = ", ".join(
                f"{s.get('kind')}[{s.get('claimUid') or '-'}]="
                f"{s.get('outcome')}"
                for s in rec.get("steps", [])
            ) or "no steps recorded"
            rollbacks = rec.get("rollbacks") or []
            trail = (
                f"plan {rec.get('planId')} {rec.get('state')}: "
                f"{rec.get('detail') or 'no detail'} — steps: {steps}"
            )
            if rollbacks:
                trail += "; rollbacks: " + ", ".join(
                    f"{r.get('claimUid')}={r.get('outcome')}"
                    for r in rollbacks
                )
            state = rec.get("state")
            if state == "failed":
                findings.append(DoctorFinding(
                    SEVERITY_DRIFT, "defrag-exec", subject,
                    trail + " — the execution intent is still on disk; "
                    "restart the plugin (recovery) or abort() the plan",
                ))
            elif state == "in-flight":
                findings.append(DoctorFinding(
                    SEVERITY_INFO, "defrag-exec", subject,
                    trail + " — execution in progress",
                ))
            else:
                findings.append(DoctorFinding(
                    SEVERITY_INFO, "defrag-exec", subject, trail,
                ))

    if cluster is None:
        return findings
    # Nodes whose /debug/usage scrape failed have an UNKNOWN hold set —
    # keep them out of the placement checks (their collect error above
    # already reports them) rather than read "no holds" into a
    # not-prepared finding for every claim allocated there.
    usage_known = [n for n in nodes if n.usage is not None]
    scraped = {n.pool_name for n in usage_known}
    # Per-node held UIDs: every placement check below must be node-local
    # (a claim held on the WRONG node must not satisfy the right one).
    held_by_node = {
        n.pool_name: {h.get("claimUid", "") for h in n.holds}
        for n in usage_known
    }

    for node in nodes:
        for hold in node.holds:
            uid = hold.get("claimUid", "")
            claim = claims_by_uid.get(uid)
            if claim is None:
                findings.append(DoctorFinding(
                    SEVERITY_DRIFT, "claim-gone",
                    f"{node.name}/{uid}",
                    f"node holds prepared claim "
                    f"{hold.get('namespace')}/{hold.get('name')} but no "
                    "ResourceClaim with that UID exists (orphan cleaner "
                    "should unprepare it)",
                ))
                continue
            results = _allocation_results(claim, driver_name)
            # Node pools the allocation actually targets. ICI channel
            # results are cluster-scoped and place no node-pool devices;
            # they are recognized by DEVICE name ("ici-channel-<n>",
            # driver-controlled) — never by pool name, which for node
            # pools is the operator-controlled node name and may itself
            # start with "ici-".
            node_pools = {
                r.get("pool", "") for r in results
                if not _is_channel_result(r)
            }
            if node_pools and node.pool_name not in node_pools:
                findings.append(DoctorFinding(
                    SEVERITY_DRIFT, "wrong-node",
                    f"{node.name}/{uid}",
                    f"node holds prepared claim "
                    f"{hold.get('namespace')}/{hold.get('name')} but its "
                    f"allocation targets {sorted(node_pools)} (stale "
                    "prepare from a superseded placement)",
                ))
                continue
            allocated = {
                r.get("device", "") for r in results
                if r.get("pool") == node.pool_name
            }
            # ICI channels come from the controller's cluster pools, not
            # the node pool — compare node-pool devices only.
            held_node = {
                d.get("name", "?") for d in hold.get("devices", [])
                if d.get("type") != "ici"
            }
            if allocated and held_node != allocated:
                findings.append(DoctorFinding(
                    SEVERITY_DRIFT, "devices-mismatch",
                    f"{node.name}/{uid}",
                    f"prepared {sorted(held_node)} but allocation says "
                    f"{sorted(allocated)}",
                ))

    for uid, claim in sorted(claims_by_uid.items()):
        md = claim.get("metadata") or {}
        for r in _allocation_results(claim, driver_name):
            if _is_channel_result(r):
                continue  # cluster pools; nothing to prepare on a node
            pool = r.get("pool", "")
            if pool in scraped and uid not in held_by_node.get(pool, ()):
                findings.append(DoctorFinding(
                    SEVERITY_INFO, "not-prepared",
                    f"{pool}/{uid}",
                    f"claim {md.get('namespace')}/{md.get('name')} is "
                    f"allocated to {pool} but not prepared there (pod "
                    "may not have started yet)",
                ))
                break

    published_channels, allocated_channels = ici_occupancy(
        cluster, driver_name
    )
    if allocated_channels > published_channels:
        findings.append(DoctorFinding(
            SEVERITY_DRIFT, "ici",
            "channels",
            f"{allocated_channels} ICI channels allocated but only "
            f"{published_channels} published",
        ))
    return findings


def _defrag_plan_for(
    nodes: list[NodeScrape], claim_uid: str
) -> Optional[dict]:
    """The newest defrag plan any node serves for this claim uid."""
    best = None
    for node in nodes:
        for plan in ((node.defrag or {}).get("plans") or []):
            if not isinstance(plan, dict):
                continue
            if (plan.get("claim") or {}).get("uid") != claim_uid:
                continue
            if best is None or plan.get("ts", 0) >= best.get("ts", 0):
                best = plan
    return best


def _is_channel_result(result: dict) -> bool:
    """Whether an allocation result is an ICI channel (cluster pool)
    rather than a node-pool device — keyed on the driver-controlled
    device name, never the pool name."""
    from .tpulib.deviceinfo import is_ici_channel_device_name

    return is_ici_channel_device_name(result.get("device", ""))


def _allocation_results(claim: dict, driver_name: str) -> list[dict]:
    results = (
        ((claim.get("status") or {}).get("allocation") or {})
        .get("devices", {}).get("results")
    ) or []
    return [r for r in results if r.get("driver") == driver_name]


def ici_occupancy(cluster: dict, driver_name: str) -> tuple[int, int]:
    """(published, allocated) ICI channel counts — the controller-side
    occupancy number, derived from cluster objects alone."""
    published = sum(
        len((s.get("spec") or {}).get("devices", []))
        for s in cluster["resourceSlices"]
        if "nodeSelector" in (s.get("spec") or {})
    )
    allocated = sum(
        1
        for c in cluster["resourceClaims"]
        for r in _allocation_results(c, driver_name)
        if _is_channel_result(r)
    )
    return published, allocated


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------

def render_report(
    nodes: list[NodeScrape],
    cluster: Optional[dict],
    findings: list[DoctorFinding],
    driver_name: str,
) -> str:
    lines = [
        f"tpu-dra doctor — {time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime())}",
        f"nodes scraped: {len(nodes)}"
        + (f" ({sum(1 for n in nodes if n.errors)} with collection errors)"
           if any(n.errors for n in nodes) else ""),
        "",
    ]
    for node in sorted(nodes, key=lambda n: n.name):
        usage = node.usage or {}
        cap = usage.get("capacity") or {}
        # Distinct devices per type, unioned across holds: an adminAccess
        # claim holds the same device as the workload claim it observes,
        # so summing per-mode counts would read occupancy over capacity.
        occ_devices: dict[str, set] = {}
        for hold in node.holds:
            for d in hold.get("devices", []):
                occ_devices.setdefault(d.get("type", "?"), set()).add(
                    d.get("name", "")
                )
        occupancy = ", ".join(
            f"{t} {len(occ_devices.get(t, ()))}/{cap[t]}"
            for t in sorted(cap)
        ) or "no usage data"
        lines.append(
            f"[{node.name}] {node.readiness} | {occupancy} | "
            f"holds: {len(node.holds)}"
        )
        for hold in node.holds:
            # Defensive .get()s throughout: a version-skewed plugin's
            # malformed snapshot must degrade the report, never abort
            # the run before the bundle is written.
            devs = ", ".join(
                f"{d.get('name', '?')} [{d.get('mode', '?')}]"
                for d in hold.get("devices", [])
            )
            try:
                held = f"{float(hold.get('heldSeconds', 0)):.0f}"
            except (TypeError, ValueError):
                held = "?"
            lines.append(
                f"    {hold.get('namespace')}/{hold.get('name')} "
                f"({hold.get('claimUid')}): {devs} — held {held}s"
            )
        for err in node.errors:
            lines.append(f"    COLLECTION ERROR: {err}")
    lines.append("")
    if cluster is not None:
        node_pools = sum(
            1 for s in cluster["resourceSlices"]
            if "nodeName" in (s.get("spec") or {})
        )
        published, allocated = ici_occupancy(cluster, driver_name)
        lines.append(
            f"cluster: {len(cluster['resourceSlices'])} ResourceSlices "
            f"({node_pools} node pools), "
            f"{len(cluster['resourceClaims'])} allocated claims, "
            f"ICI channels {allocated}/{published} allocated"
        )
    else:
        lines.append("cluster: (no kube access; cross-checks skipped)")
    lines.append("")
    drift = [f for f in findings if f.severity == SEVERITY_DRIFT]
    errors = [f for f in findings if f.severity == SEVERITY_ERROR]
    infos = [f for f in findings if f.severity == SEVERITY_INFO]
    if not findings:
        lines.append("diagnosis: CLEAN — cluster and node views agree")
    else:
        lines.append(
            f"diagnosis: {len(drift)} drift, {len(errors)} collection "
            f"error(s), {len(infos)} informational"
        )
        for f in findings:
            lines.append(f"  {f}")
    return "\n".join(lines) + "\n"


def write_bundle(
    path: str,
    nodes: list[NodeScrape],
    cluster: Optional[dict],
    findings: list[DoctorFinding],
    report: str,
) -> None:
    """Support-bundle tar: every raw document the diagnosis was derived
    from, so offline support can re-run the analysis."""

    def add(tar: tarfile.TarFile, name: str, text: str) -> None:
        data = text.encode()
        info = tarfile.TarInfo(name=name)
        info.size = len(data)
        info.mtime = int(time.time())
        tar.addfile(info, io.BytesIO(data))

    with tarfile.open(path, "w") as tar:
        add(tar, "report.txt", report)
        add(tar, "findings.json", json.dumps(
            [dataclasses.asdict(f) for f in findings], indent=2
        ))
        for node in nodes:
            base = f"nodes/{node.name}"
            add(tar, f"{base}/metrics.txt", node.metrics_text)
            add(tar, f"{base}/usage.json",
                json.dumps(node.usage or {}, indent=2, sort_keys=True))
            add(tar, f"{base}/traces.jsonl", node.traces_text)
            add(tar, f"{base}/readyz.txt", node.readyz_text)
            if node.allocations_text:
                add(tar, f"{base}/allocations.jsonl",
                    node.allocations_text)
            if node.defrag is not None:
                add(tar, f"{base}/defrag.json",
                    json.dumps(node.defrag, indent=2, sort_keys=True))
            if node.rebalance is not None:
                add(tar, f"{base}/rebalance.json",
                    json.dumps(node.rebalance, indent=2, sort_keys=True))
            if node.gateway is not None:
                add(tar, f"{base}/gateway.json",
                    json.dumps(node.gateway, indent=2, sort_keys=True))
            if node.residency is not None:
                add(tar, f"{base}/residency.json",
                    json.dumps(node.residency, indent=2, sort_keys=True))
            if node.compute is not None:
                add(tar, f"{base}/compute.json",
                    json.dumps(node.compute, indent=2, sort_keys=True))
            if node.requests_text or node.slo_summary is not None:
                add(tar, f"{base}/requests.json", json.dumps({
                    "slo": node.slo_summary,
                    "exemplars": node.exemplars,
                    "timelines": node.timelines,
                }, indent=2, sort_keys=True))
            if node.errors:
                add(tar, f"{base}/errors.txt", "\n".join(node.errors) + "\n")
        if cluster is not None:
            add(tar, "cluster/resourceslices.json",
                json.dumps(cluster["resourceSlices"], indent=2))
            add(tar, "cluster/resourceclaims.json",
                json.dumps(cluster["resourceClaims"], indent=2))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def run(
    node_urls: dict[str, str],
    kube_client=None,
    driver_name: str = "tpu.google.com",
    bundle: Optional[str] = None,
    timeout: float = 5.0,
    bench_dir: Optional[str] = None,
) -> tuple[str, list[DoctorFinding], int]:
    """The doctor's whole pass, kube-client-injectable so the cluster sim
    (FakeKubeClient) exercises the identical code path as production.
    Returns (report text, findings, exit status)."""
    # Scrape nodes concurrently: collection is per-node independent, and
    # a fleet with a few dark nodes (the very situation the doctor is
    # for) would otherwise stall ~4 fetch timeouts per dark node,
    # serially. Sorted input + map keeps the report order deterministic.
    from concurrent.futures import ThreadPoolExecutor

    ordered = sorted(node_urls.items())
    nodes: list[NodeScrape] = []
    if ordered:  # ThreadPoolExecutor rejects max_workers=0
        with ThreadPoolExecutor(
            max_workers=min(16, len(ordered))
        ) as pool:
            nodes = list(pool.map(
                lambda nu: collect_node(nu[0], nu[1], timeout=timeout),
                ordered,
            ))
    cluster = None
    cluster_error = None
    if kube_client is not None:
        try:
            cluster = collect_cluster(kube_client, driver_name)
        except Exception as e:
            logger.exception("cluster collection failed")
            cluster_error = DoctorFinding(
                SEVERITY_ERROR, "collect", "cluster", str(e)
            )
    bench_mfu = None
    if bench_dir:
        from .models.compute_telemetry import (
            bench_mfu_baseline, load_bench_trajectory,
        )

        bench_mfu = bench_mfu_baseline(load_bench_trajectory(bench_dir))
    findings = fleet_findings(
        nodes, cluster, driver_name, bench_mfu=bench_mfu
    )
    if cluster_error is not None:
        findings.append(cluster_error)
    report = render_report(nodes, cluster, findings, driver_name)
    if bundle:
        write_bundle(bundle, nodes, cluster, findings, report)
    status = 0
    if any(f.severity == SEVERITY_DRIFT for f in findings):
        status = 1
    if any(f.severity == SEVERITY_ERROR for f in findings):
        status = 2
    return report, findings, status


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-dra-doctor",
        description="Fleet-wide TPU DRA diagnosis + support bundles "
                    "(read-only)",
    )
    p.add_argument(
        "--node", action="append", default=[], metavar="NAME=URL",
        help="a node plugin's debug endpoint, e.g. "
             "node-a=http://10.0.0.11:8081 (repeatable)",
    )
    p.add_argument("--driver-name", default="tpu.google.com")
    p.add_argument("--kubeconfig", default="",
                   help="kubeconfig path (default: in-cluster)")
    p.add_argument("--no-kube", action="store_true",
                   help="skip apiserver cross-checks (node scrapes only)")
    p.add_argument("--bundle", default="",
                   help="write a support-bundle tar of all raw documents "
                        "to this path")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="per-request scrape timeout, seconds")
    p.add_argument("--bench-dir", default="",
                   help="directory of committed BENCH_r*.json rounds; "
                        "enables the mfu-regression cross-check against "
                        "the trajectory's best mfu_fraction round")
    p.add_argument("--json", action="store_true",
                   help="emit findings as JSON instead of the report")
    return p


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    node_urls: dict[str, str] = {}
    for spec in args.node:
        name, sep, url = spec.partition("=")
        if not sep or not name or not url:
            print(f"--node must be NAME=URL, got {spec!r}", file=sys.stderr)
            return 2
        node_urls[name] = url
    if not node_urls:
        print("at least one --node NAME=URL is required", file=sys.stderr)
        return 2
    client = None
    if not args.no_kube:
        from .utils.cli import make_kube_client

        try:
            client = make_kube_client(args.kubeconfig)
        except (OSError, ValueError) as exc:
            print(
                f"cannot build a kube client ({exc}); pass --kubeconfig "
                "or use --no-kube for node-scrape-only diagnosis",
                file=sys.stderr,
            )
            return 2
    report, findings, status = run(
        node_urls,
        kube_client=client,
        driver_name=args.driver_name,
        bundle=args.bundle or None,
        timeout=args.timeout,
        bench_dir=args.bench_dir or None,
    )
    if args.json:
        print(json.dumps(
            [dataclasses.asdict(f) for f in findings], indent=2
        ))
    else:
        print(report, end="")
    if args.bundle:
        print(f"support bundle written to {args.bundle}", file=sys.stderr)
    return status


if __name__ == "__main__":
    sys.exit(main())
