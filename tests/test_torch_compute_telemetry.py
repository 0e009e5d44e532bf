"""The port's compute telemetry (``models/compute_telemetry.py`` and
``parallel/collectives.py``) against the JAX package's, on the CPU at
``tiny``.

Mirrors the parts of the reference's tests/test_compute_telemetry.py that
the port has: the roofline math and peak table (with the H100 row), the
collective byte convention, the compile ledger against the engine's
``compile_counts``, the pool-exact HBM ledger, explicit steps and the
train seam, and the ``/debug/compute`` endpoint. Beside them the
reference's ``ComputeTelemetry`` and the port's watch the same traffic
on a reference and a port engine (same parameters, the same explicit
peaks, one injected clock each): the rendered ``tpu_dra_compute_*`` text
and ``compute_debug()`` are equal. Every clock the telemetry reads is
the injected one, so no field reads the wall clock (``compileS``, the
compile-seconds histogram and ``windowS`` come from it). The one
difference is by design: the port's pools carry one scratch row, which
``kvPoolBytes``, ``totalBytes`` and the ``kv_pool`` gauge count (its
exact bytes are checked); the per-token KV bytes and ``kvUsedBytes``
count positions only, so they equal the reference's. And the telemetry
costs nothing: on and off, the tokens, ticks, ``compile_counts`` and
launch counters are identical. Last, the doctor's compute checks
(``recompile-storm``, ``mfu-regression``) and the BENCH trajectory
loader run on both packages with equal findings and rows.
"""

import json
import os
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu import doctor as rdoctor
from k8s_dra_driver_tpu.models import compute_telemetry as rct
from k8s_dra_driver_tpu.models.llama import PRESETS as REF_PRESETS
from k8s_dra_driver_tpu.models.llama import init_params as ref_init
from k8s_dra_driver_tpu.models.serving import DecodeEngine as RefEngine
from k8s_dra_driver_tpu.parallel import collectives as rcollectives
from k8s_dra_driver_tpu.utils.metrics import Registry as RefRegistry
from k8s_dra_driver_tpu_torch import doctor
from k8s_dra_driver_tpu_torch.models import DecodeEngine, params_from_numpy
from k8s_dra_driver_tpu_torch.models import compute_telemetry as ct
from k8s_dra_driver_tpu_torch.models import decode as tdecode
from k8s_dra_driver_tpu_torch.models.llama import PRESETS
from k8s_dra_driver_tpu_torch.models.step_graph import read_launches
from k8s_dra_driver_tpu_torch.parallel import collectives
from k8s_dra_driver_tpu_torch.utils.metrics import MetricsServer, Registry
from test_torch_doctor import RECOMPILE_TEXT

TINY = PRESETS["tiny"]

# Ridge point 1e6 / 1e3 = 1000 FLOPs/byte: easy to straddle from a test.
FAKE_PEAKS = {
    "kind": "fake-chip", "matched": "fake",
    "peakFlopsPerS": 1.0e6, "peakBytesPerS": 1.0e3,
}
CPU_PEAKS = ct.device_peaks("cpu")


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


@pytest.fixture(autouse=True)
def first_uses():
    """Eagerly, the forward's seam reports a shape's first use in the
    process (``decode.TRACE_COUNTS``); each test starts from none, as each
    reference engine's programs trace anew."""
    tdecode.TRACE_COUNTS.clear()
    yield


@pytest.fixture(scope="module")
def tiny():
    jp = ref_init(REF_PRESETS["tiny"], jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), TINY,
                                 device="cpu")


@pytest.fixture(scope="module")
def params(tiny):
    return tiny[1]


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, TINY.vocab_size, size=n)]
            for n in lens]


def _kw(**over):
    kw = dict(batch_slots=2, num_blocks=12, block_size=8, max_seq_len=48,
              prefill_chunk=8)
    kw.update(over)
    return kw


def _engine(params, **kw):
    return DecodeEngine(params, TINY, device="cpu", **_kw(**kw))


def _churn_prompts():
    # Shared prefix x varied tails, submitted twice: repeats hit the
    # radix cache, variety against the 12-block pool forces evictions.
    base = _prompts(11, (16,))[0]
    tails = _prompts(12, (5, 8, 11, 14))
    return [base + t for t in tails] * 2


def _drive(eng, prompts, n_new=8):
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    eng.run()
    eng.assert_no_leaks()
    return reqs


def _telemetry(registry=None, **kw):
    return ct.ComputeTelemetry(registry or Registry(),
                               peaks=kw.pop("peaks", CPU_PEAKS), **kw)


class TestRooflineMath:
    """Pure roofline classification on the fake peak table, equal to the
    reference's; the peak table's rows."""

    @pytest.mark.parametrize("args", [
        (1e6, 1e4, 2.0, 1e6, 1e3),     # intensity 100 < ridge: memory
        (1e6, 1e2, 1.0, 1e6, 1e3),     # intensity 1e4 > ridge: compute
        (0.0, 0.0, 5.0, 1e6, 1e3),     # idle
        (1e6, 1e4, 0.0, 1e6, 1e3),     # a zero window is idle
    ], ids=["memory", "compute", "idle", "zero-window"])
    def test_equals_reference(self, args):
        assert ct.roofline(*args) == rct.roofline(*args)

    def test_memory_bound(self):
        r = ct.roofline(1e6, 1e4, 2.0, 1e6, 1e3)
        assert r["boundBy"] == "memory"
        assert r["flopsPerS"] == pytest.approx(5e5)
        assert r["bytesPerS"] == pytest.approx(5e3)
        assert r["mfu"] == pytest.approx(0.5)
        assert r["membwFraction"] == pytest.approx(5.0)
        assert r["intensity"] == pytest.approx(100.0)
        assert r["ridge"] == pytest.approx(1000.0)

    def test_compute_bound_and_idle(self):
        r = ct.roofline(1e6, 1e2, 1.0, 1e6, 1e3)
        assert r["boundBy"] == "compute"
        assert r["mfu"] == pytest.approx(1.0)
        r = ct.roofline(0.0, 0.0, 5.0, 1e6, 1e3)
        assert r["boundBy"] == "idle" and r["mfu"] == 0.0
        assert r["windowS"] == 5.0
        assert ct.roofline(1e6, 1e4, 0.0, 1e6, 1e3)["boundBy"] == "idle"

    def test_device_peaks_matches_known_kind(self):
        row = ct.device_peaks("TPU v5e chip")
        assert row == rct.device_peaks("TPU v5e chip")
        assert row["matched"] == "v5e"

    def test_h100_row_matches_only_the_sxm_part(self):
        """The H100 row is the SXM part's data-sheet bf16 and HBM3 peaks;
        the PCIe part (756 TFLOP/s, 2.0 TB/s) must not take it."""
        row = ct.device_peaks("NVIDIA H100 80GB HBM3")
        assert row["matched"] == "h100 80gb hbm3"
        assert row["peakFlopsPerS"] == 989e12
        assert row["peakBytesPerS"] == 3.35e12
        assert row["kind"] == "NVIDIA H100 80GB HBM3"
        pcie = ct.device_peaks("NVIDIA H100 PCIe")
        assert pcie["matched"] == "cpu"
        assert pcie["peakFlopsPerS"] == ct.PEAK_TABLE["cpu"][0]

    def test_device_peaks_unknown_falls_back_to_cpu(self):
        row = ct.device_peaks("Quantum Banana 9000")
        assert row == rct.device_peaks("Quantum Banana 9000")
        assert row["matched"] == "cpu"

    def test_device_peaks_reads_the_card_or_raises(self):
        """No kind: the current card's name; with no card it raises and
        never takes the cpu row on its own."""
        if torch.cuda.is_available():
            assert ct.device_peaks()["kind"] == torch.cuda.get_device_name()
            return
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ct.device_peaks()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ct.ComputeTelemetry(Registry())


class TestCollectiveConvention:
    """The analytic byte formulas and the zero-cost emit contract."""

    def test_formulas(self):
        for mod in (collectives, rcollectives):
            assert mod.permute_bytes(100, 4) == 400
            assert mod.permute_bytes(100, 1) == 0  # self-permute
            assert mod.all_gather_bytes(100, 4) == 1200
            assert mod.all_to_all_bytes(100, 4) == 300
            assert mod.all_reduce_bytes(100, 4) == 600
        x = torch.zeros((3, 5), dtype=torch.float32)
        assert collectives.payload_bytes(x.shape, x.dtype) == 60
        y = torch.zeros((3, 5), dtype=torch.bfloat16)
        assert collectives.payload_bytes(y.shape, y.dtype) == 30

    def test_emit_is_noop_without_ledger(self):
        assert not collectives._LEDGERS
        collectives.emit("nowhere", collectives.MEDIUM_ICI, 1 << 40)
        assert not collectives._LEDGERS

    def test_ledger_records_and_uninstalls(self):
        ledger = collectives.CollectiveLedger()
        ledger.install()
        try:
            collectives.emit("a.site", "ici", 100)
            collectives.emit("a.site", "ici", 50, invocations=2)
            collectives.emit("b.site", "dcn", 7)
        finally:
            ledger.uninstall()
        collectives.emit("a.site", "ici", 999)  # after uninstall: dropped
        snap = ledger.snapshot()
        assert snap == [
            {"site": "a.site", "medium": "ici",
             "bytes": 150, "invocations": 3},
            {"site": "b.site", "medium": "dcn",
             "bytes": 7, "invocations": 1},
        ]
        json.dumps(snap)


class TestCompileLedger:
    """Ledger invariants against a live engine's compile seam."""

    def test_builds_equal_engine_compile_counts(self, params):
        tel = _telemetry()
        eng = _engine(params)
        tel.attach(eng, replica="r0", claim_uid="uid-1")
        try:
            _drive(eng, _prompts(0, (5, 11, 17)))
            counts = dict(eng.compile_counts)
            assert counts == {"decode_step": 1, "prefill_chunk": 1}
            snap = tel.ledger.snapshot()
            for program, n in counts.items():
                assert snap["builds"][program] == n, program
            # The forward's seam reports too (prefill and decode run
            # distinct shapes of the same forward).
            assert snap["builds"]["forward"] == 2
            assert snap["recompilesSinceWarm"] == {}
            timed = [r for r in snap["records"] if r["program"] in counts]
            assert len(timed) == 2
            for r in timed:
                assert r["variant"] == "bf16"
                assert r["compileS"] > 0
                assert r["flops"] > 0 and r["bytes"] > 0
                assert r["afterWarm"] is False
        finally:
            tel.close()
        # Detached: the engine's step objects are back.
        assert type(eng._decode).__name__ == "StepGraph"
        assert type(eng._prefill).__name__ == "StepGraph"

    def test_steady_state_does_not_recompile(self, params):
        tel = _telemetry()
        eng = _engine(params)
        tel.attach(eng, replica="r0")
        try:
            _drive(eng, _prompts(1, (6, 9)))
            tel.mark_warm()
            _drive(eng, _prompts(2, (7, 12)))  # same shapes, new prompts
            assert tel.ledger.snapshot()["recompilesSinceWarm"] == {}
            assert dict(eng.compile_counts) == {
                "decode_step": 1, "prefill_chunk": 1,
            }
        finally:
            tel.close()

    def test_build_after_warm_is_a_recompile(self, params):
        """Warm before any traffic: the first builds arrive through the
        seam as recompiles, under one program name in the record and the
        counter's label."""
        registry = Registry()
        tel = _telemetry(registry)
        eng = _engine(params)
        tel.attach(eng, replica="r0")
        try:
            tel.mark_warm()
            _drive(eng, _prompts(5, (6, 9)))
            snap = tel.ledger.snapshot()
            assert snap["recompilesSinceWarm"]["decode_step"] == 1
            rec = [r for r in snap["records"]
                   if r["program"] == "decode_step"][-1]
            assert rec["afterWarm"] is True
            assert ('tpu_dra_compute_recompiles_total'
                    '{program="decode_step"} 1') in registry.render()
        finally:
            tel.close()

    def test_variant_label_tracks_quantized_cache(self, params):
        tel = _telemetry()
        eng = _engine(params, quantize_cache=True)
        tel.attach(eng, replica="r0")
        try:
            _drive(eng, _prompts(3, (6,)))
            recs = [r for r in tel.ledger.snapshot()["records"]
                    if r["program"] == "decode_step"]
            assert recs and all(r["variant"] == "kvq" for r in recs)
        finally:
            tel.close()


class TestHbmLedger:
    """The footprint decomposition is pool-exact, not an estimate."""

    def _assert_exact(self, eng):
        hbm = ct.engine_hbm(eng)
        assert hbm["weightsBytes"] == sum(
            t.numel() * t.element_size()
            for t in (eng.params["embed"], eng.params["final_norm"],
                      eng.params["lm_head"],
                      *eng.params["layers"].values()))
        assert hbm["weightsBytes"] == ct.tree_nbytes(eng.params)
        assert hbm["kvPoolBytes"] == sum(
            p.numel() * p.element_size() for p in eng._pools)
        assert hbm["totalBytes"] == (
            hbm["weightsBytes"] + hbm["kvPoolBytes"])
        occ = eng.allocator.occupancy()
        used = eng.allocator.num_blocks - occ["free"]
        assert hbm["kvUsedBlocks"] == used
        # The in-use blocks' rows (the scratch row is no block's).
        rows = sum(p[:, :, :used * eng.block_size].numel()
                   * p.element_size() for p in eng._pools)
        assert hbm["kvUsedBytes"] == rows

    def test_exact_under_eviction_churn(self, params):
        eng = _engine(params)
        _drive(eng, _churn_prompts(), n_new=12)
        assert eng.kv_residency()["evictedBlocks"] > 0
        self._assert_exact(eng)

    def test_exact_quantized_pools(self, params):
        # int8 KV pools carry scales; "exact" must mean what was actually
        # allocated, not 2 bytes x elements.
        eng = _engine(params, quantize_cache=True)
        _drive(eng, _churn_prompts(), n_new=12)
        assert {p.dtype for p in eng._pools} == {torch.int8, torch.float32}
        self._assert_exact(eng)

    def test_exact_int8_weights(self, params):
        """A QuantTensor counts its q and scale."""
        from k8s_dra_driver_tpu_torch.models.quant import quantize_params

        q = quantize_params(params)
        w = q["layers"]["wqkv"]
        assert ct.tree_nbytes(w) == (w.q.numel() + 4 * w.scale.numel())

    def test_watermark_survives_drain(self, params):
        tel = _telemetry()
        eng = _engine(params)
        tel.attach(eng, replica="r0")
        try:
            _drive(eng, _churn_prompts(), n_new=12)
            hbm = tel.compute_debug()["hbm"]["r0"]
            assert hbm["watermarkBytes"] > 0
            # All requests retired: in-use is below the mid-run peak.
            assert hbm["watermarkBytes"] >= hbm["kvUsedBytes"]
            assert hbm["claimUid"] is None
        finally:
            tel.close()


class TestExternalSteps:
    """observe_step: the roofline path for programs without an engine seam
    (train loops), on the fake peak table; the train step's seam."""

    def test_roofline_and_counters(self):
        registry = Registry()
        tel = _telemetry(registry, peaks=FAKE_PEAKS)
        try:
            tel.observe_step("train_step", 2.0, flops=1e6, nbytes=1e4,
                             steps=4, replica="t0")
            doc = tel.compute_debug()
            r = doc["programs"]["train_step"]["t0"]
            assert r["mfu"] == pytest.approx(0.5)
            assert r["flopsPerS"] == pytest.approx(5e5)
            assert r["boundBy"] == "memory"
            assert r["steps"] == 4
            assert doc["device"]["matched"] == "fake"
            assert ('tpu_dra_compute_steps_total'
                    '{program="train_step",replica="t0"} 4') in \
                registry.render()
        finally:
            tel.close()

    def test_train_trace_seam_records_build(self):
        from k8s_dra_driver_tpu_torch.models import train

        tel = _telemetry(peaks=FAKE_PEAKS)
        try:
            opt = train.make_optimizer(warmup_steps=1, total_steps=10)
            state = train.init_train_state(TINY, opt, seed=0, device="cpu")
            step = train.make_train_step(TINY, opt, device="cpu")
            tokens = torch.randint(0, TINY.vocab_size, (2, 19),
                                   generator=torch.Generator().manual_seed(2))
            key = "train_step:b2:s19"
            train.TRACE_COUNTS.pop(key, None)
            state, loss = step(state, tokens)
            state, loss = step(state, tokens)
            assert float(loss) > 0
            assert train.TRACE_COUNTS[key] == 1
            records = [r for r in tel.ledger.snapshot()["records"]
                       if r["program"] == "train_step"]
            assert len(records) == 1
            assert records[0]["shapes"] == {"batch": 2, "seq": 19}
            hbm = ct.train_state_hbm(state)
            assert hbm["paramsBytes"] == ct.tree_nbytes(state.params)
            # AdamW's two f32 moments per parameter.
            assert hbm["optimizerBytes"] == 2 * sum(
                p.numel() * 4 for p in train.leaves(state.params))
        finally:
            tel.close()


class TestEndpointContract:
    def test_404_without_provider_200_with_405_on_write(self, params):
        registry = Registry()
        srv = MetricsServer(registry, host="127.0.0.1", port=0)
        srv.start()
        tel = _telemetry(registry)
        try:
            base = f"http://127.0.0.1:{srv.port}"
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"{base}/debug/compute")
            assert ei.value.code == 404

            eng = _engine(params)
            tel.attach(eng, replica="r0", claim_uid="uid-ep")
            _drive(eng, _prompts(4, (6, 9)))
            srv.set_compute_provider(tel.compute_debug)
            served = json.loads(urllib.request.urlopen(
                f"{base}/debug/compute").read().decode())
            assert served["schema"] == "tpu-dra-compute-debug-v1"
            assert served["builds"]["decode_step"] == 1
            assert served["hbm"]["r0"]["claimUid"] == "uid-ep"
            assert served["hbm"]["r0"]["totalBytes"] == (
                served["hbm"]["r0"]["weightsBytes"]
                + served["hbm"]["r0"]["kvPoolBytes"]
            )

            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"{base}/debug/compute", data=b"x")
            assert ei.value.code == 405
            assert "GET" in (ei.value.headers.get("Allow") or "")
        finally:
            tel.close()
            srv.stop()


def _compute_lines(text: str) -> list:
    return [line for line in text.splitlines() if "tpu_dra_compute_" in line]


def _serve(engine, telemetry, registry):
    """Churn traffic with the telemetry attached, scraped every tick;
    returns the streams, the scrapes' compute lines and the document."""
    telemetry.attach(engine, replica="r0", claim_uid="uid-1")
    reqs = [engine.submit(p, max_new_tokens=12) for p in _churn_prompts()]
    scrapes = []
    while not engine.idle:
        engine.tick()
        scrapes.append(_compute_lines(registry.render()))
    doc = telemetry.compute_debug()
    final = _compute_lines(registry.render())
    telemetry.close()
    return [r.tokens for r in reqs], scrapes, final, doc


@pytest.mark.parametrize("quantize_cache", [False, True],
                         ids=["bf16", "kvq"])
def test_text_and_document_equal_reference(tiny, quantize_cache):
    jp, tp = tiny
    ref_reg, reg = RefRegistry(), Registry()
    ref = _serve(
        RefEngine(jp, REF_PRESETS["tiny"], clock=_Clock(),
                  quantize_cache=quantize_cache, **_kw()),
        rct.ComputeTelemetry(ref_reg, peaks=dict(FAKE_PEAKS),
                             clock=_Clock()),
        ref_reg)
    eng = DecodeEngine(tp, TINY, device="cpu", clock=_Clock(),
                       quantize_cache=quantize_cache, **_kw())
    port = _serve(eng, ct.ComputeTelemetry(reg, peaks=dict(FAKE_PEAKS),
                                           clock=_Clock()), reg)
    assert port[0] == ref[0]
    scratch = sum(p[:, :, -1:].numel() * p.element_size()
                  for p in eng._pools)
    assert scratch > 0

    def pool_line(line):
        return 'component="kv_pool"' in line

    assert len(port[1]) == len(ref[1]) > 0
    for got, want in zip(port[1] + [port[2]], ref[1] + [ref[2]]):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if pool_line(a):
                head, value = a.rsplit(" ", 1)
                assert b == f"{head} {int(float(value)) - scratch}", (a, b)
            else:
                assert a == b
    doc, ref_doc = port[3], json.loads(json.dumps(ref[3]))
    hbm, ref_hbm = doc["hbm"]["r0"], ref_doc["hbm"]["r0"]
    for key in ("kvPoolBytes", "totalBytes"):
        assert hbm[key] - ref_hbm[key] == scratch
        ref_hbm[key] = hbm[key]
    assert json.loads(json.dumps(doc)) == ref_doc
    assert doc["builds"] == {"forward": 2, "prefill_chunk": 1,
                             "decode_step": 1}
    assert doc["programs"]["decode_step"]["r0"]["boundBy"] == "memory"


@pytest.mark.parametrize("overlap", [True, False])
def test_telemetry_is_zero_cost(params, overlap):
    """Telemetry ON (attached, scraped every tick) vs OFF: the same
    tokens, tick counts, ``compile_counts`` and launch counters."""
    runs = []
    for on in (False, True):
        eng = _engine(params, overlap=overlap, clock=_Clock())
        reg = Registry()
        tel = _telemetry(reg) if on else None
        if on:
            tel.attach(eng, replica="r0")
        launches = read_launches()
        reqs = [eng.submit(p, max_new_tokens=12) for p in _churn_prompts()]
        while not eng.idle:
            eng.tick()
            if on:
                reg.render()
        if on:
            tel.close()
        runs.append(([r.tokens for r in reqs], eng.stats.ticks,
                     dict(eng.compile_counts),
                     tuple(b - a for a, b in zip(launches, read_launches())),
                     eng.snapshot()))
    assert runs[0] == runs[1]


# -- the doctor's compute checks and the BENCH trajectory ---------------------
# (test_compute_telemetry.py's TestDoctorComputeChecks and
# TestBenchTrajectory): each check runs on both packages' doctors and
# loaders, and their findings and rows must be equal (the port's
# recompile-storm text written as the reference's, RECOMPILE_TEXT).


def _doctor_findings(compute, bench_mfu=None):
    """Both doctors' findings on one node's /debug/compute document."""
    seen = []
    for dr in (rdoctor, doctor):
        scrape = dr.NodeScrape(name="node-a", url="http://x")
        scrape.compute = compute
        seen.append([(f.severity, f.check, f.subject, f.detail.replace(
            RECOMPILE_TEXT[1], RECOMPILE_TEXT[0])) for f in dr.fleet_findings(
                [scrape], {"resourceSlices": [], "resourceClaims": []},
                "tpu.google.com", bench_mfu=bench_mfu)])
    assert seen[1] == seen[0]
    return seen[1]


class TestDoctorComputeChecks:
    def test_recompile_after_warm_is_drift(self):
        found = _doctor_findings({"warm": True,
                                  "recompilesSinceWarm": {"decode_step": 3}})
        storm = [f for f in found if f[1] == "recompile-storm"]
        assert len(storm) == 1 and storm[0][0] == doctor.SEVERITY_DRIFT
        assert storm[0][2] == "node-a/decode_step"
        assert "3 recompile(s)" in storm[0][3]

    def test_builds_before_warm_are_not_storms(self):
        found = _doctor_findings({"warm": False, "recompilesSinceWarm": {},
                                  "builds": {"decode_step": 4}})
        assert not any(f[1] == "recompile-storm" for f in found)

    def test_mfu_regression_needs_baseline_and_steps(self):
        compute = {"warm": True, "recompilesSinceWarm": {},
                   "programs": {"decode_step": {
                       "r0": {"mfu": 0.10, "steps": 50,
                              "boundBy": "memory"}}}}
        reg = [f for f in _doctor_findings(compute, bench_mfu=0.40)
               if f[1] == "mfu-regression"]
        assert len(reg) == 1 and reg[0][2] == "node-a/r0/decode_step"
        assert "memory-bound" in reg[0][3]
        assert not any(f[1] == "mfu-regression"
                       for f in _doctor_findings(compute, bench_mfu=0.15))
        assert not any(f[1] == "mfu-regression"
                       for f in _doctor_findings(compute))
        compute["programs"]["decode_step"]["r0"]["steps"] = 0
        assert not any(f[1] == "mfu-regression"
                       for f in _doctor_findings(compute, bench_mfu=0.40))

    def test_acceptance_triple_for_injected_storm(self, params):
        """ONE injected recompile storm surfaces the same program name in
        the port's CompileLedger record, its recompiles_total label and
        both doctors' DRIFT finding."""
        registry = Registry()
        tel = _telemetry(registry)
        eng = _engine(params)
        tel.attach(eng, replica="r0")
        try:
            tel.mark_warm()
            _drive(eng, _prompts(5, (6, 9)))
            program = "decode_step"
            snap = tel.ledger.snapshot()
            assert snap["recompilesSinceWarm"][program] == 1
            rec = [r for r in snap["records"] if r["program"] == program][-1]
            assert rec["afterWarm"] is True
            assert (f'tpu_dra_compute_recompiles_total'
                    f'{{program="{program}"}} 1') in registry.render()
            storm = [f for f in _doctor_findings(tel.compute_debug())
                     if f[1] == "recompile-storm"
                     and f[2] == f"node-a/{program}"]
            assert len(storm) == 1 and storm[0][0] == doctor.SEVERITY_DRIFT
        finally:
            tel.close()


def _both_loaders(bench_dir):
    rows = [m.load_bench_trajectory(str(bench_dir)) for m in (rct, ct)]
    assert rows[1] == rows[0]
    baselines = [m.bench_mfu_baseline(rows[1]) for m in (rct, ct)]
    assert baselines[1] == baselines[0]
    return rows[1], baselines[1]


class TestBenchTrajectory:
    def _write(self, path, doc):
        path.write_text(json.dumps(doc))

    def test_loader_tolerates_old_rounds_and_junk(self, tmp_path):
        self._write(tmp_path / "BENCH_r01.json", {"n": 1, "parsed": {
            "metric": "llama3_tiny_train_mfu_b8_s128", "value": 0.31,
            "unit": "mfu_fraction"}})
        self._write(tmp_path / "BENCH_r02.json", {"n": 2, "parsed": [
            {"metric": "llama3_tiny_train_mfu_b8_s128", "value": 0.42,
             "unit": "mfu_fraction", "repeats": 3, "spread": 0.01,
             "detail": {"step_ms": 10.0}},
            {"metric": "llama3_tiny_decode_toks_b8_p128", "value": 900.0,
             "unit": "tokens_per_s"},
            "not-a-dict"]})
        (tmp_path / "BENCH_r03.json").write_text("{ truncated")
        rows, baseline = _both_loaders(tmp_path)
        assert [r["round"] for r in rows] == [1, 2, 2]
        assert rows[0]["repeats"] == 1 and rows[0]["spread"] == 0.0
        assert rows[0]["detail"] == {}
        assert baseline == pytest.approx(0.42)

    def test_baseline_none_without_mfu_rounds(self, tmp_path):
        assert ct.bench_mfu_baseline([]) is None
        self._write(tmp_path / "BENCH_r01.json", {"n": 1, "parsed": [{
            "metric": "x_decode_toks", "value": 1.0,
            "unit": "tokens_per_s"}]})
        assert _both_loaders(tmp_path)[1] is None

    def test_committed_trajectory_parses_alike(self):
        """The repo's BENCH rounds (TPU rounds of the JAX package) read
        the same through both loaders. They are no baseline for the
        port: its doctor is given rounds measured on the card."""
        rows, baseline = _both_loaders(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert rows and baseline is not None
