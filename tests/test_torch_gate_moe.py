"""``tools/run_moe_smoke_torch.py`` against ``tools/run_moe_smoke.py`` on
one seed, on the CPU at ``tiny-moe`` with the reference's parameters.

Decisions only: each impl's train-step loss against the reference's
printed loss, each impl's logits at drop-free capacity and the fused and
primitive dispatches' logits against the JAX package's forward within
``tests/test_torch_moe.py``'s tolerance (atol = rtol = 1e-4), the auto
policy's picks, and every deterministic gate (compile-once included).
The spread tripwire reads the wall clock and is not held here.
"""

import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest

from test_torch_gate_common import load_tool, one_torch_thread

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def runs():
    with one_torch_thread():
        import jax

        from k8s_dra_driver_tpu.models import moe as jmoe
        from k8s_dra_driver_tpu_torch.models import moe, params_from_numpy

        ref = load_tool("run_moe_smoke")
        twin = load_tool("run_moe_smoke_torch")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            ref.main()
        base = moe.MOE_PRESETS["tiny-moe"]
        jp = jmoe.init_params(jmoe.MOE_PRESETS["tiny-moe"],
                              jax.random.PRNGKey(ref.SEED))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), base, device="cpu")
        out = twin.run(tp, base, "cpu", emit=lambda line: None)
        return printed.getvalue(), jp, out


def test_losses_equal_the_reference(runs):
    printed, _, out = runs
    ref_losses = dict(re.findall(r"moebench (\w+): .* loss ([0-9.]+)",
                                 printed))
    assert set(ref_losses) == {"einsum", "binned", "dropless"}
    for impl, loss in ref_losses.items():
        assert abs(out["losses"][impl] - float(loss)) <= 1e-4, impl


@pytest.mark.parametrize("impl", ["einsum", "binned", "dropless"])
def test_impl_logits_equal_the_reference(runs, impl):
    import jax.numpy as jnp

    from k8s_dra_driver_tpu.models import moe as jmoe

    _, jp, out = runs
    tokens = load_tool("run_moe_smoke_torch").seeded_tokens(
        jmoe.MOE_PRESETS["tiny-moe"].vocab_size)
    cfg = dataclasses.replace(jmoe.MOE_PRESETS["tiny-moe"],
                              capacity_factor=8.0, router_group=0,
                              moe_impl=impl)
    want, _ = jmoe.forward(jp, jnp.asarray(tokens[:, :-1], jnp.int32), cfg)
    np.testing.assert_allclose(out["outputs"][impl].numpy(),
                               np.asarray(want), **TOL)
    if impl == "dropless":
        for dispatch in ("fused", "primitive"):
            np.testing.assert_allclose(out["dispatched"][dispatch].numpy(),
                                       np.asarray(want), **TOL)


def test_auto_policy_and_gates_equal_the_reference(runs):
    from k8s_dra_driver_tpu.models import moe as jmoe

    _, _, out = runs
    want = [jmoe.resolve_moe_impl(jmoe.MOE_PRESETS[p], b * s)
            for p, b, s, _ in load_tool("run_moe_smoke_torch").AUTO_CASES]
    assert out["auto"] == want
    assert out["gates"].failures(kinds=("gate",)) == []
    assert sum(k == "gate" and "retraced" in w
               for _, w, k in out["gates"].results) == 6
