"""Grammar-driven fuzz of the port's CEL-subset engine.

Twin of ``test_cel_fuzz.py`` on ``k8s_dra_driver_tpu_torch.kube.cel``:
the same grammar generator and mutations (imported from the reference
test), the same seeds and sample counts. The port keeps the engine's
contract (any selector evaluates to a bool or raises its ``CelError``,
never a raw Python exception), and one thing the reference test cannot
check: on every sample the two packages agree, either on the same bool
or both raising their ``CelError``.
"""

import random

import pytest
from test_cel_fuzz import ATTRS, CAPACITY, DRIVER, gen_expr, mutate

from k8s_dra_driver_tpu.kube import cel as ref_cel
from k8s_dra_driver_tpu_torch.kube import cel


def verdict(module, expr):
    """The engine's answer: the bool, or "CelError" when it refuses."""
    try:
        out = module.evaluate(expr, DRIVER, ATTRS, CAPACITY)
    except module.CelError:
        return "CelError"
    assert isinstance(out, bool), (expr, out)
    return out


def samples(seed):
    rng = random.Random(seed)
    for i in range(300):
        expr = gen_expr(rng)
        if i % 3 == 0:
            expr = mutate(rng, expr)
        yield expr


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_contract_holds(seed):
    seen = {"CelError": 0, True: 0, False: 0}
    for expr in samples(seed):
        port = verdict(cel, expr)
        assert port == verdict(ref_cel, expr), expr
        seen[port] += 1
    # The samples reach all three outcomes.
    assert all(seen.values()), seen


def test_known_type_mismatches_stay_in_contract():
    """The advisory's exact bug class: comparisons across types must not
    leak TypeError."""
    cases = [
        f'device.attributes["{DRIVER}"].uuid >= 16',
        f'device.capacity["{DRIVER}"].hbm >= 16',
        f'device.attributes["{DRIVER}"].index == "two" && true',
        f'!(device.attributes["{DRIVER}"].healthy >= "yes")',
    ]
    for expr in cases:
        assert verdict(cel, expr) == verdict(ref_cel, expr), expr
