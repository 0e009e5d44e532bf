"""The port's copy of ``utils/metrics.py`` against the JAX package's.

The same sequence of counter, gauge and histogram operations (labels,
escaping, buckets, removals, aliases, render hooks, refused names) runs
on a reference ``Registry`` and on the port's; the rendered exposition
text, the read-back values and the refusals must be EQUAL. One
parametrised test, one case per sequence.
"""

import math

import pytest

from k8s_dra_driver_tpu.utils import metrics as ref_metrics
from k8s_dra_driver_tpu_torch.utils import metrics as port_metrics


def _counters(m):
    reg = m.Registry()
    c = m.Counter("tpu_dra_test_requests_total", "Requests by outcome",
                  reg)
    c.inc()
    c.inc(2.5)
    c.inc(0.0, outcome="failed")
    c.inc(3, outcome="completed", replica="r0")
    c.inc(1, replica="r0", outcome="completed")
    return reg, [c.value(), c.value(outcome="failed"),
                 c.value(outcome="completed", replica="r0"),
                 c.value(outcome="never")]


def _escaping(m):
    reg = m.Registry()
    g = m.Gauge("tpu_dra_test_label_values", "Odd label values", reg)
    g.set(1, path='C:\\tmp\\"x"')
    g.set(2, msg="line one\nline two")
    g.set(-3.25, empty="")
    g.set(7, unicode="r\u00e9plica \u2014 0")
    return reg, [g.value(path='C:\\tmp\\"x"'), g.value(empty="")]


def _gauges(m):
    reg = m.Registry()
    g = m.Gauge("tpu_dra_test_pool_blocks", "Pool blocks by state", reg)
    for state, n in (("free", 10), ("cached", 3), ("private", 0)):
        g.set(n, replica="r0", state=state)
        g.set(n + 1, replica="r1", state=state)
    g.remove(replica="r1", state="cached")
    g.remove(replica="gone", state="free")
    g.set(float("inf"), replica="r2", state="free")
    g.set(float("-inf"), replica="r2", state="cached")
    g.set(float("nan"), replica="r2", state="private")
    g.set(1e-7, replica="r3", state="free")
    g.set(123456789012, replica="r3", state="cached")
    v = g.value(replica="r2", state="private")
    return reg, [g.value(replica="r0", state="free"),
                 g.value(replica="r1", state="cached"),
                 "nan" if math.isnan(v) else v]


def _histograms(m):
    reg = m.Registry()
    plain = m.Histogram("tpu_dra_test_latency_seconds", "Latency", reg)
    ages = m.Histogram("tpu_dra_test_ages_ops", "Ages", reg,
                       buckets=(64, 1, 8, 2))
    empty = m.Histogram("tpu_dra_test_unobserved", "Nothing yet", reg,
                        buckets=(0.5,))
    for v in (0.001, 0.01, 0.3, 7, 12, 0.005):
        plain.observe(v)
    for v in (1, 3, 9, 65, 2, 2):
        ages.observe(v, replica="r0")
    ages.zero(replica="r1")
    ages.observe(0.5, replica="r2", phase="admit")
    return reg, [plain.summary(), ages.summary(replica="r0"),
                 ages.summary(), ages.summary(replica="absent"),
                 empty.summary(), plain.buckets, ages.buckets]


def _aliases_and_hooks(m):
    reg = m.Registry()
    c = m.Counter("tpu_dra_test_new_total", "Renamed counter", reg)
    reg.alias("tpu_dra_test_old_total", c)
    g = m.Gauge("tpu_dra_test_synced", "Synced at scrape", reg)
    h = m.Histogram("tpu_dra_test_new_seconds", "Renamed histogram", reg,
                    buckets=(1, 10))
    reg.alias("tpu_dra_test_old_seconds", h)
    calls = []

    def hook():
        calls.append(1)
        g.set(len(calls), source="hook")

    def broken():
        raise RuntimeError("a broken hook must not take the scrape down")

    reg.add_render_hook(hook)
    reg.add_render_hook(broken)
    c.inc(4, kind="a")
    h.observe(5)
    reg.render()
    return reg, [len(calls), g.value(source="hook")]


def _refusals(m):
    reg = m.Registry()
    m.Counter("tpu_dra_test_once_total", "Once", reg)
    out = []
    attempts = (
        lambda: m.Counter("tpu_dra_test_once_total", "Twice", reg),
        lambda: m.Gauge("0bad-name", "Bad", reg),
        lambda: m.Gauge("tpu_dra_test_ok", "Ok", reg).set(
            1, **{"bad-label": "x"}),
        lambda: m.Histogram("tpu_dra_test_h", "H", reg).observe(1, le="1"),
        lambda: m.Counter("tpu_dra_test_neg_total", "Neg", reg).inc(-1),
    )
    for attempt in attempts:
        try:
            attempt()
            out.append(None)
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    return reg, out


SCENARIOS = {
    "counters": _counters,
    "escaping": _escaping,
    "gauges": _gauges,
    "histograms": _histograms,
    "aliases_and_hooks": _aliases_and_hooks,
    "refusals": _refusals,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_registry_renders_like_the_reference(scenario):
    ref_reg, ref_values = SCENARIOS[scenario](ref_metrics)
    port_reg, port_values = SCENARIOS[scenario](port_metrics)
    assert port_values == ref_values
    ref_text, port_text = ref_reg.render(), port_reg.render()
    assert port_text == ref_text
    assert port_text.endswith("\n") and "# TYPE" in port_text
