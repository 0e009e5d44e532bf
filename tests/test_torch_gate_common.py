"""What the port's gate twins share in their parity tests, and the rule
every model twin keeps: it runs on the card unless ``--device cpu`` is
given, and without a card it raises instead of falling back.

The ``tests/test_torch_gate_*.py`` files each run one reference tool
and its ``_torch`` twin in process on one seed and hold their decisions
equal (token streams, ``compile_counts``, ticks, ledgers, plans), never
their wall clocks. They load both tools from ``tools/`` as
``tests/test_torch_alloc_bench.py`` does, and wrap a tool's module-level
steps (``build_engine``, ``drive``) to record what each engine decided.
"""

import contextlib
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(name):
    """``tools/<name>.py`` as a module (cached in ``sys.modules``)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def tiny_params():
    """The reference tools' ``tiny`` parameters (``PRNGKey(0)``) and the
    port's copy of them on the CPU."""
    import jax
    import numpy as np

    from k8s_dra_driver_tpu.models.llama import PRESETS as REF_PRESETS
    from k8s_dra_driver_tpu.models.llama import init_params as ref_init
    from k8s_dra_driver_tpu_torch.models import params_from_numpy
    from k8s_dra_driver_tpu_torch.models.llama import PRESETS

    jp = ref_init(REF_PRESETS["tiny"], jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree.map(np.asarray, jp), PRESETS["tiny"],
                             device="cpu")


class Recorder:
    """Wraps ``module.<name>`` for each name so that every call's return
    value is appended to ``self.calls[name]``."""

    def __init__(self, module, monkeypatch, *names):
        self.calls = {name: [] for name in names}
        for name in names:
            real = getattr(module, name)

            def wrapped(*args, _real=real, _name=name, **kwargs):
                out = _real(*args, **kwargs)
                self.calls[_name].append(out)
                return out

            monkeypatch.setattr(module, name, wrapped)


def engine_facts(engine) -> tuple:
    """What an engine decided that a wall clock cannot change."""
    return dict(engine.compile_counts), engine.stats.ticks


@contextlib.contextmanager
def one_torch_thread():
    """The tiny presets' ops are too small to share among threads: one
    intra-op thread keeps them quick where the suite's workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


MODEL_TOOLS = ("run_decode_smoke_torch", "run_kv_smoke_torch",
               "run_trace_smoke_torch", "run_compute_smoke_torch",
               "run_moe_smoke_torch", "run_elastic_smoke_torch",
               "run_gateway_smoke_torch")


@pytest.mark.parametrize("name", MODEL_TOOLS)
def test_model_tools_raise_without_a_card(name):
    """Without ``--device cpu`` a model twin asks for the card, and with
    no card it raises before it runs anything: it never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_tool(name).main([])


@pytest.mark.parametrize("name", MODEL_TOOLS)
def test_model_tools_take_a_device_flag(name):
    tool = load_tool(name)
    with pytest.raises(SystemExit) as exc:
        tool.main(["--help"])
    assert exc.value.code == 0
