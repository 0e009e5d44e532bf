"""The port engine's KV telemetry (``DecodeEngine.kv_debug`` and
``KVTelemetry``) against the JAX package's, on the CPU at ``tiny``.

Mirrors the reference's tests/test_serving.py::TestKVLedger on port
engines, with the reference engine serving the same traffic beside them:
the residency digest stays consistent through eviction and preemption
churn, the ``/debug/kv`` document and the ``tpu_dra_kv_*`` text equal
the reference's, the port's ``MetricsServer`` serves ``/debug/kv`` (GET
only), and telemetry is a pure observer (tokens, ticks and
``compile_counts`` identical with it on and off).
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from k8s_dra_driver_tpu.models.llama import PRESETS as REF_PRESETS
from k8s_dra_driver_tpu.models.llama import init_params as ref_init
from k8s_dra_driver_tpu.models.serving import DecodeEngine as RefEngine
from k8s_dra_driver_tpu.models.serving import KVTelemetry as RefKVTelemetry
from k8s_dra_driver_tpu.utils.metrics import Registry as RefRegistry
from k8s_dra_driver_tpu_torch.models import DecodeEngine, params_from_numpy
from k8s_dra_driver_tpu_torch.models.llama import PRESETS
from k8s_dra_driver_tpu_torch.models.serving import KVTelemetry
from k8s_dra_driver_tpu_torch.utils.metrics import MetricsServer, Registry

FAMILIES = ("tpu_dra_kv_pool_blocks", "tpu_dra_kv_indexed_blocks",
            "tpu_dra_kv_prefix_runs", "tpu_dra_kv_evicted_blocks_total",
            "tpu_dra_kv_evicted_tokens_total",
            "tpu_dra_kv_alloc_misses_total", "tpu_dra_kv_revivals_total",
            "tpu_dra_kv_cow_recomputes_total",
            "tpu_dra_kv_eviction_lru_age_ops",
            "tpu_dra_kv_request_footprint_blocks")


@pytest.fixture(scope="module")
def tiny():
    jp = ref_init(REF_PRESETS["tiny"], jax.random.PRNGKey(0))
    cfg = PRESETS["tiny"]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jp, tp, cfg


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 256, size=n)] for n in lens]


def _churn_prompts():
    # A shared 16-token system prefix x varied tails, each submitted
    # twice: repeats hit the radix cache (COW on the trailing block);
    # variety against the 12-block pool forces evictions.
    base = _prompts(11, (16,))[0]
    tails = _prompts(12, (5, 8, 11, 14))
    return [base + t for t in tails] * 2


def _kw(**over):
    kw = dict(batch_slots=2, num_blocks=12, block_size=8, max_seq_len=48,
              prefill_chunk=8)
    kw.update(over)
    return kw


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _serve(engine, prompts, max_new, registry, telemetry_cls):
    """Serve ``prompts`` on ``engine`` with a KVTelemetry attached,
    scraping after every tick; returns the scrapes and the streams."""
    tel = telemetry_cls(registry)
    tel.attach(engine, replica="kv-test")
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    scrapes = []
    while not engine.idle:
        engine.tick()
        scrapes.append(registry.render())
    engine.assert_no_leaks()
    assert all(r.done for r in reqs)
    final = registry.render()
    tel.detach("kv-test")
    return dict(streams=[r.tokens for r in reqs], scrapes=scrapes,
                final=final, detached=registry.render(),
                digest=engine.kv_residency(), kv_debug=engine.kv_debug(),
                occupancy=engine.allocator.occupancy(),
                snapshot=engine.snapshot())


@pytest.fixture(scope="module", params=["eviction", "preemption"])
def churn(request, tiny):
    """The reference engine and the port engine on one churn scenario:
    prefix-cache eviction (the shared-prefix family against a 12-block
    pool) or preemption (the starvation profile, 6 blocks, 3 slots)."""
    jp, tp, cfg = tiny
    if request.param == "eviction":
        prompts, max_new, kw = _churn_prompts(), 12, _kw()
    else:
        prompts, max_new = _prompts(4, (7, 9, 6, 8, 7)), 10
        kw = _kw(batch_slots=3, num_blocks=6)
    ref = _serve(RefEngine(jp, REF_PRESETS["tiny"], clock=_Clock(), **kw),
                 prompts, max_new, RefRegistry(), RefKVTelemetry)
    eng = DecodeEngine(tp, cfg, device="cpu", clock=_Clock(), **kw)
    port = _serve(eng, prompts, max_new, Registry(), KVTelemetry)
    return request.param, ref, port, eng, len(prompts)


def test_digest_consistent_after_churn(churn):
    kind, ref, port, eng, _ = churn
    assert port["streams"] == ref["streams"]
    digest = port["digest"]
    assert digest == ref["digest"]
    assert digest["schema"] == "tpu-dra-kv-residency-v1"
    assert digest["indexedBlocks"] == (digest["insertedBlocks"]
                                       - digest["evictedBlocks"])
    assert sum(port["occupancy"].values()) == eng.allocator.num_blocks
    assert port["occupancy"] == ref["occupancy"]
    if kind == "eviction":
        assert digest["evictedBlocks"] > 0, "scenario must evict"
        for run in digest["runs"]:
            assert run["blocks"] > 0
            assert set(run["refs"]) == {"cached", "live", "shared"}
    else:
        assert eng.stats.preemptions > 0, "scenario must preempt"


def test_kv_debug_document_equals_reference(churn):
    _, ref, port, _, n_requests = churn
    doc = port["kv_debug"]
    assert doc == ref["kv_debug"]
    assert doc["schema"] == "tpu-dra-kv-debug-v1"
    assert sum(doc["occupancy"].values()) == doc["blocksTotal"]
    assert doc["footprintBlocks"]["samples"] == n_requests
    json.dumps(doc)
    assert port["snapshot"] == ref["snapshot"]


def test_telemetry_renders_reference_text_and_detaches(churn):
    kind, ref, port, eng, _ = churn
    assert port["scrapes"] == ref["scrapes"]
    assert port["final"] == ref["final"]
    assert port["detached"] == ref["detached"]
    for family in FAMILIES:
        assert family in port["final"], family
    evicted = port["digest"]["evictedBlocks"]
    line = f'tpu_dra_kv_evicted_blocks_total{{replica="kv-test"}} {evicted}'
    assert line in port["final"] and line in port["detached"]
    assert 'tpu_dra_kv_pool_blocks{replica="kv-test"' not in \
        port["detached"], "a departed replica's pool gauges linger"
    if kind == "eviction":
        assert evicted > 0


def test_debug_kv_endpoint_serves_the_document(churn):
    _, ref, _, eng, _ = churn
    srv = MetricsServer(Registry(), host="127.0.0.1", port=0)
    srv.set_kv_provider(eng.kv_debug)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        served = json.loads(urllib.request.urlopen(
            f"{base}/debug/kv").read().decode())
        assert served == json.loads(json.dumps(ref["kv_debug"]))
        res = served["residency"]
        assert res["indexedBlocks"] == (res["insertedBlocks"]
                                        - res["evictedBlocks"])
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/debug/kv", data=b"x")
        assert ei.value.code == 405
        assert "GET" in ei.value.headers.get("Allow", "")
    finally:
        srv.stop()


@pytest.mark.parametrize("overlap", [True, False])
def test_telemetry_is_zero_cost(tiny, overlap):
    """Telemetry ON (attached, scraped every tick) vs OFF: the same
    tokens, tick counts and compile counts."""
    _, tp, cfg = tiny
    runs = []
    for on in (False, True):
        eng = DecodeEngine(tp, cfg, device="cpu", overlap=overlap,
                           clock=_Clock(), **_kw())
        reg = Registry()
        if on:
            KVTelemetry(reg).attach(eng, replica="r0")
        reqs = [eng.submit(p, max_new_tokens=12) for p in _churn_prompts()]
        while not eng.idle:
            eng.tick()
            if on:
                reg.render()
        runs.append(([r.tokens for r in reqs], eng.stats.ticks,
                     dict(eng.compile_counts), eng.snapshot()))
    assert runs[0] == runs[1]
