"""``tools/verify_metrics_torch.py`` against ``tools/verify_metrics.py``.

The twin keeps its own copy of the exposition parser and the cardinality
bounds: both copies give the same verdict on the renderer's edge cases.
The twin's self-test scrape (the port's debug server over every family
the reference's self-test registers) is clean under both parsers, and
its metric families equal the reference's, but for ``BY_DESIGN``. With
``--url`` both tools give the same verdict on the same live server.
"""

import contextlib
import io
import math
import re

import pytest

from test_torch_gate_common import load_tool

# Families one self-test renders and the other does not. None today: the
# port registers every family the reference's self-test does.
BY_DESIGN = frozenset()

EDGE_CASES = {
    "clean": "# HELP m Help\n# TYPE m gauge\nm 1\n",
    "repr_inf": "# TYPE m gauge\nm inf\n",
    "plus_inf_nan": "# TYPE m gauge\nm{a=\"x\"} +Inf\nm{a=\"y\"} NaN\n"
                    "m{a=\"z\"} -Inf\n",
    "unescaped_quote": '# TYPE m gauge\nm{a="un"quoted"} 1\n',
    "escaped_label": '# TYPE m counter\nm{a="q\\"b\\\\s\\nn"} 1\n',
    "raw_newline_in_label": '# TYPE m gauge\nm{a="x\ny"} 1\n',
    "orphan_sample": "orphan_sample 1\n",
    "histogram_no_inf": "# TYPE h histogram\nh_bucket{le=\"1\"} 1\n"
                        "h_sum 1\nh_count 1\n",
    "histogram_ok": "# TYPE h histogram\nh_bucket{le=\"1\"} 1\n"
                    "h_bucket{le=\"+Inf\"} 1\nh_sum 1\nh_count 1\n",
    "conflicting_type": "# TYPE m gauge\n# TYPE m counter\nm 1\n",
    "malformed_type": "# TYPE m gauges\nm 1\n",
    "malformed_help": "# HELP 9m help\n# TYPE m gauge\nm 1\n",
    "timestamp": "# TYPE m gauge\nm 1 1700000000\n",
    "bad_name": "# TYPE m gauge\n9m 1\n",
    "exponent": "# TYPE m gauge\nm 1.5e-07\nm{b=\"c\"} .5\n",
    "comment": "# just a comment\n# TYPE m gauge\nm 1\n",
    "many_chip_series": "# TYPE c gauge\n" + "".join(
        f'c{{chip="{i}"}} 1\n' for i in range(70)),
    "many_series": "# TYPE s gauge\n" + "".join(
        f's{{k="{i}"}} 1\n' for i in range(40)),
}


def families(body: str) -> set:
    return {m.group(1) for m in re.finditer(r"^# TYPE (\S+) ", body, re.M)}


@pytest.fixture(scope="module")
def tools():
    return load_tool("verify_metrics"), load_tool("verify_metrics_torch")


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_parsers_give_the_reference_verdict(tools, case):
    ref, twin = tools
    text = EDGE_CASES[case]
    assert twin.validate_exposition(text) == ref.validate_exposition(text)
    for bounds in ((500, 64), (30, 64), (500, 8)):
        assert twin.check_cardinality(text, *bounds) == \
            ref.check_cardinality(text, *bounds)


@pytest.fixture(scope="module")
def scrapes(tools):
    ref, twin = tools
    with contextlib.redirect_stderr(io.StringIO()):
        return ref._self_test_scrape(), twin._self_test_scrape()


def test_port_self_test_scrape_is_clean_under_both_parsers(tools, scrapes):
    ref, twin = tools
    _, (body, errors) = scrapes
    assert errors == []
    assert body
    for tool in (ref, twin):
        assert tool.validate_exposition(body) == []
        assert tool.check_cardinality(body) == []


def test_families_equal_the_reference(scrapes):
    (ref_body, ref_errors), (body, _) = scrapes
    assert ref_errors == []
    assert families(body) ^ families(ref_body) == BY_DESIGN
    assert len(families(body)) > 70


def test_url_mode_gives_the_reference_verdict(tools):
    from k8s_dra_driver_tpu_torch.utils.metrics import (
        Counter,
        Gauge,
        MetricsServer,
        Registry,
    )

    ref, twin = tools
    registry = Registry()
    Counter("tpu_dra_url_total", "Url", registry).inc(path='a"b')
    Gauge("tpu_dra_url_temp", "Temp", registry).set(math.inf, chip="0")
    srv = MetricsServer(registry, host="127.0.0.1", port=0)
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        verdicts = []
        for tool in (ref, twin):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = tool.main(["--url", url])
            verdicts.append((rc, err.getvalue()))
        tight = []
        for tool in (ref, twin):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = tool.main(["--url", url, "--max-chip-series", "0"])
            tight.append((rc, err.getvalue()))
    finally:
        srv.stop()
    assert verdicts[0] == verdicts[1] and verdicts[0][0] == 0
    assert tight[0] == tight[1] and tight[0][0] == 1
