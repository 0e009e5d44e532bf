"""Sequence parallelism of the port against the JAX package's, on the CPU:
the twins of ``tests/test_parallel.py``'s ``TestRingAttention``,
``TestFlashRingAttention`` and ``TestUlyssesAttention``, the collective
ledger's ``ring_attention.kv`` and ``ulysses.all_to_all`` bytes, the hop
counts the card's launch formulas rest on, and the sequence-parallel
model (the twin of ``tests/test_models.py``'s sequence-parallel train step
and ring-equals-flash forward).

The reference runs on conftest's 8 virtual CPU devices; the port on
meshes of CPU shards, where the flash form's hops run the plain versions
of K4-K6 and K9. The reference's ``impl="auto"`` is its einsum form on the
CPU, the main yardstick; its flash form runs Pallas in interpret mode,
slow, so only the smallest cases hold the port to it. Tolerances, the
reference's own: f32, 2e-5 forward, 2e-4 gradients; the model's as in
``tests/test_torch_mesh_train.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_dra_driver_tpu.models import llama as jllama
from k8s_dra_driver_tpu.models import moe as jmoe
from k8s_dra_driver_tpu.models import train as jtrain
from k8s_dra_driver_tpu.ops import attention_reference as jattention
from k8s_dra_driver_tpu.parallel import MeshConfig as JMeshConfig
from k8s_dra_driver_tpu.parallel import ring as jring_mod
from k8s_dra_driver_tpu.parallel import build_mesh as jbuild_mesh
from k8s_dra_driver_tpu.parallel import collectives as jcollectives
from k8s_dra_driver_tpu.parallel import ring_attention as jring
from k8s_dra_driver_tpu.parallel import ulysses_attention as julysses
from k8s_dra_driver_tpu.parallel.sharding import shard_pytree as jshard
from k8s_dra_driver_tpu_torch.models import llama, moe
from k8s_dra_driver_tpu_torch.models import train as ttrain
from k8s_dra_driver_tpu_torch.models.convert import params_from_numpy
from k8s_dra_driver_tpu_torch.ops import attention as att
from k8s_dra_driver_tpu_torch.parallel import (
    MeshConfig,
    build_mesh,
    collectives,
    ring,
    ring_attention,
    ulysses_attention,
)

CPU = torch.device("cpu")
TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
JTINY, TINY = jllama.PRESETS["tiny"], llama.PRESETS["tiny"]


def _cpu_mesh(**axes):
    mc = MeshConfig(**axes)
    return build_mesh(mc, devices=[CPU] * mc.num_devices)


def _jmesh(**axes):
    mc = JMeshConfig(**axes)
    return jbuild_mesh(mc, devices=jax.devices()[:mc.num_devices])


def _qkv(b=2, h=4, s=256, d=32, hkv=None):
    """The reference's ``_qkv`` inputs (PRNG keys 0, 1, 2) as numpy."""
    hkv = hkv or h
    shapes = ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))
    return tuple(np.asarray(jax.random.normal(jax.random.PRNGKey(i), sh))
                 for i, sh in enumerate(shapes))


def _torch(*xs, grad=False):
    return tuple(torch.tensor(x).requires_grad_(grad) for x in xs)


def _expand(k, q):
    return np.repeat(k, q.shape[1] // k.shape[1], axis=1)


def _attention(q, k, v, causal):
    """The reference's ``attention_reference`` with kv repeated."""
    return np.asarray(jattention(q, _expand(k, q), _expand(v, q),
                                 causal=causal))


def _ref_grads(q, k, v, causal=True):
    return jax.grad(
        lambda q_, k_, v_: jattention(
            q_, jnp.repeat(k_, q.shape[1] // k.shape[1], axis=1),
            jnp.repeat(v_, q.shape[1] // k.shape[1], axis=1),
            causal=causal).sum(),
        argnums=(0, 1, 2))(q, k, v)


def _port_grads(fn, q, k, v):
    leaves = _torch(q, k, v, grad=True)
    out = fn(*leaves)
    return out, torch.autograd.grad(out.sum(), leaves)


# ---------------------------------------------------------------------------
# TestRingAttention: the reference's "auto" (its einsum form on the CPU).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_reference_seq4(causal, impl):
    q, k, v = _qkv()
    want = np.asarray(jring(q, k, v, _jmesh(fsdp=2, sequence=4),
                            causal=causal))
    np.testing.assert_allclose(want, _attention(q, k, v, causal), **TOL)
    got = ring_attention(*_torch(q, k, v), _cpu_mesh(fsdp=2, sequence=4),
                         causal=causal, impl=impl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_with_tensor_parallel_heads():
    q, k, v = _qkv(b=1, h=4, s=128, d=32)
    want = np.asarray(jring(q, k, v, _jmesh(sequence=4, tensor=2)))
    got = ring_attention(*_torch(q, k, v), _cpu_mesh(sequence=4, tensor=2))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _attention(q, k, v, True), **TOL)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_gqa(impl):
    q, k, v = _qkv(b=1, h=8, s=256, d=32, hkv=2)
    want = np.asarray(jring(q, k, v, _jmesh(sequence=8)))
    got = ring_attention(*_torch(q, k, v), _cpu_mesh(sequence=8), impl=impl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _attention(q, k, v, True), **TOL)


def test_two_calls_equal():
    """The twin of ``test_jit_compiles_once``: the port builds no
    program, so the pin is that a second call repeats the first bit for
    bit and the ledger records each call once."""
    q, k, v = _torch(*_qkv(b=1, h=2, s=128, d=32))
    mesh = _cpu_mesh(sequence=4)
    ledger = collectives.CollectiveLedger()
    ledger.install()
    try:
        first = ring_attention(q, k, v, mesh)
        second = ring_attention(q, k, v, mesh)
    finally:
        ledger.uninstall()
    assert torch.equal(first, second)
    assert ledger.snapshot()[0]["invocations"] == 2


# ---------------------------------------------------------------------------
# TestFlashRingAttention: the flash form, per-hop K4 + lse merge, skipped
# hops, GQA-native rotation and the whole ring's backward.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference(causal):
    q, k, v = _qkv(b=1, h=2, s=128, d=32)
    got = ring_attention(*_torch(q, k, v), _cpu_mesh(sequence=4),
                         causal=causal, impl="flash")
    want = _attention(q, k, v, causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if causal:
        # The reference's own flash form (Pallas, interpret mode) once.
        jflash = np.asarray(jring(q, k, v, _jmesh(sequence=4), causal=True,
                                  impl="flash"))
        np.testing.assert_allclose(got.numpy(), jflash, **TOL)


def test_flash_gqa_rotates_native_heads(monkeypatch):
    q, k, v = _qkv(b=1, h=8, s=128, d=32, hkv=2)
    moved = []
    real = ring.ring_permute_group
    monkeypatch.setattr(ring, "ring_permute_group", lambda rings, shift=1: (
        moved.extend(x.shape for r in rings for x in r), real(rings,
                                                               shift))[1])
    got = ring_attention(*_torch(q, k, v), _cpu_mesh(sequence=4),
                         impl="flash")
    np.testing.assert_allclose(got.numpy(), _attention(q, k, v, True), **TOL)
    assert moved and all(s[1] == 2 for s in moved)   # 2 kv heads, not 8


def test_flash_grads_match_reference():
    q, k, v = _qkv(b=1, h=2, s=128, d=32)
    _, got = _port_grads(lambda q_, k_, v_: ring_attention(
        q_, k_, v_, _cpu_mesh(sequence=4), impl="flash"), q, k, v)
    for a, b in zip(got, _ref_grads(q, k, v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_flash_grads_match_the_reference_flash_ring():
    """The whole ring's backward against the reference's custom VJP
    (Pallas interpret mode) on the smallest ring: 2 shards of 64."""
    q, k, v = _qkv(b=1, h=2, s=128, d=32)
    jm = _jmesh(sequence=2)
    want = jax.grad(lambda q_, k_, v_: jring(q_, k_, v_, jm,
                                             impl="flash").sum(),
                    argnums=(0, 1, 2))(q, k, v)
    _, got = _port_grads(lambda q_, k_, v_: ring_attention(
        q_, k_, v_, _cpu_mesh(sequence=2), impl="flash"), q, k, v)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_flash_gqa_with_tensor_parallel_falls_back_to_repeat():
    # hkv=2 does not divide tensor=4: the flash form repeats kv heads
    # (here to the full group) rather than fail to cut them.
    q, k, v = _qkv(b=1, h=8, s=64, d=32, hkv=2)
    got = ring_attention(*_torch(q, k, v), _cpu_mesh(sequence=2, tensor=4),
                         impl="flash")
    want = np.asarray(jring(q, k, v, _jmesh(sequence=2, tensor=4),
                            impl="xla"))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _attention(q, k, v, True), **TOL)


def test_flash_gqa_grads():
    q, k, v = _qkv(b=1, h=4, s=128, d=32, hkv=2)
    _, got = _port_grads(lambda q_, k_, v_: ring_attention(
        q_, k_, v_, _cpu_mesh(sequence=4), impl="flash"), q, k, v)
    for a, b in zip(got, _ref_grads(q, k, v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_xla_form_grads_match_plain_attention(causal):
    """The plain form's gradient is autograd's through the m/l merge with
    the shift m held constant; it matches plain attention's. (The
    reference's einsum form stops m only in the exponent, and its dq and
    dk then differ from plain attention's by O(1): not held to it.)"""
    q, k, v = _qkv(b=1, h=4, s=128, d=32, hkv=2)
    _, got = _port_grads(lambda q_, k_, v_: ring_attention(
        q_, k_, v_, _cpu_mesh(sequence=4, tensor=2), causal=causal,
        impl="xla"), q, k, v)
    for a, b in zip(got, _ref_grads(q, k, v, causal)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


# ---------------------------------------------------------------------------
# TestUlyssesAttention and the all-to-all.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_reference(causal):
    q, k, v = _qkv(b=2, h=4, s=256, d=32)
    want = np.asarray(julysses(q, k, v, _jmesh(fsdp=2, sequence=4),
                               causal=causal))
    got = ulysses_attention(*_torch(q, k, v), _cpu_mesh(fsdp=2, sequence=4),
                            causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _attention(q, k, v, causal),
                               **TOL)


def test_ulysses_gqa_grads():
    q, k, v = _qkv(b=2, h=8, s=64, d=32, hkv=2)
    _, got = _port_grads(lambda q_, k_, v_: ulysses_attention(
        q_, k_, v_, _cpu_mesh(data=2, sequence=4)), q, k, v)
    for a, b in zip(got, _ref_grads(q, k, v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_all_to_all_is_the_tiled_exchange():
    mesh = _cpu_mesh(data=2, sequence=4)
    vals = [torch.arange(4 * 8).reshape(4, 8) + 100 * i for i in range(8)]
    out = collectives.all_to_all(vals, mesh, "sequence", 0, 1)
    for group in mesh.groups("sequence"):
        for i, idx in enumerate(group):
            want = torch.cat([vals[j][i:i + 1] for j in group], dim=1)
            assert torch.equal(out[idx], want)
    vals[1] = None
    with pytest.raises(ValueError, match="with and without"):
        collectives.all_to_all(vals, mesh, "sequence", 0, 1)
    none = collectives.all_to_all([None] * 8, mesh, "sequence", 0, 1)
    assert none == [None] * 8


# ---------------------------------------------------------------------------
# The ledger and the hop counts.
# ---------------------------------------------------------------------------


def _records(pkg, fn):
    ledger = pkg.CollectiveLedger()
    ledger.install()
    try:
        fn()
    finally:
        ledger.uninstall()
    return ledger.snapshot()


@pytest.mark.parametrize("case", ["flash_gqa", "xla_gqa", "flash_repeat",
                                  "ulysses"])
def test_ledger_bytes_equal_the_reference(case):
    """``ring_attention.kv`` (flash: native GQA heads; xla: repeated; a
    kv count that does not cut over tensor: the smallest repeat) and
    ``ulysses.all_to_all`` (four exchanges) byte for byte."""
    if case == "ulysses":
        q, k, v = _qkv(b=2, h=8, s=64, d=32, hkv=2)
        axes = dict(data=2, sequence=4)
        jfn = lambda: julysses(q, k, v, _jmesh(**axes))  # noqa: E731
        tfn = lambda: ulysses_attention(  # noqa: E731
            *_torch(q, k, v), _cpu_mesh(**axes))
    else:
        q, k, v = _qkv(b=1, h=8, s=64, d=32, hkv=2)
        axes = (dict(sequence=2, tensor=4) if case == "flash_repeat"
                else dict(sequence=4))
        impl = "xla" if case == "xla_gqa" else "flash"
        jfn = lambda: jring(q, k, v, _jmesh(**axes),  # noqa: E731
                            impl=impl)
        tfn = lambda: ring_attention(*_torch(q, k, v),  # noqa: E731
                                     _cpu_mesh(**axes), impl=impl)
    want = _records(jcollectives, jfn)
    got = _records(collectives, tfn)
    assert got == want and len(got) == 1


@pytest.mark.parametrize("causal", [True, False])
def test_hop_launch_counts(monkeypatch, causal):
    """The hops PERF.md's launch formulas count, per ring of n: K4 on the
    n(n+1)/2 visible pairs under the causal mask (n^2 without), K5 and K6
    on the same pairs in the backward; K9 n - 1 grouped calls forward (no
    rotation after the last hop), n backward (the carriers' last hop
    home), every ring of the call in each."""
    n, rings = 4, 2
    calls = {"fwd": 0, "dkdv": 0, "dq": 0, "k9": []}
    for name, key in (("flash_fwd", "fwd"), ("flash_bwd_dkdv", "dkdv"),
                      ("flash_bwd_dq", "dq")):
        real = getattr(att, name)

        def counted(*a, _real=real, _key=key):
            calls[_key] += 1
            return _real(*a)
        monkeypatch.setattr(att, name, counted)
    real_k9 = ring.ring_permute_group

    def k9(rings_, shift=1):
        calls["k9"].append(len(rings_))
        return real_k9(rings_, shift)
    monkeypatch.setattr(ring, "ring_permute_group", k9)
    q, k, v = _qkv(b=1, h=4, s=64, d=32, hkv=2)
    out, _ = _port_grads(lambda q_, k_, v_: ring_attention(
        q_, k_, v_, _cpu_mesh(sequence=n, tensor=rings), causal=causal),
        q, k, v)
    pairs = n * (n + 1) // 2 if causal else n * n
    assert calls["fwd"] == calls["dkdv"] == calls["dq"] == rings * pairs
    # Forward: k and v of both rings; backward: k, v, dk, dv, then dk, dv.
    assert calls["k9"] == [2 * rings] * (n - 1) + [4 * rings] * (n - 1) \
        + [2 * rings]


def test_hop_classes_and_pair_limit():
    assert [ring._hop_class(j, 2, True) for j in range(4)] == [1, 1, 0, 2]
    assert {ring._hop_class(j, 2, False) for j in range(4)} == {1}
    # A backward hop of 2 tensor shards over 4 sequence shards on one
    # card: k, v, dk, dv of 8 rings of 4 in one launch.
    assert ring.MAX_PAIRS == 4 * 2 * 4


# ---------------------------------------------------------------------------
# The model on a sequence axis.
# ---------------------------------------------------------------------------


def _tokens(b, s, vocab=TINY.vocab_size, seed=0) -> np.ndarray:
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (b, s), 0,
                                         vocab))


@pytest.fixture(scope="module")
def tiny():
    jp = jllama.init_params(JTINY, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), TINY,
                                 device="cpu")


def test_ring_matches_flash_forward(tiny):
    """The twin of ``test_ring_matches_flash_forward``: ``use_ring`` on
    sequence 4 x tensor 2 against the single device, and the reference's
    ring forward on its mesh."""
    jp, tp = tiny
    t = _tokens(2, 64)
    jmesh = _jmesh(sequence=4, tensor=2)
    want = np.asarray(jllama.forward(jp, jnp.asarray(t), JTINY, mesh=jmesh,
                                     use_ring=True))
    ref = llama.forward(tp, torch.tensor(t), TINY)
    for use_ring in (True, False):
        got = llama.forward(tp, torch.tensor(t), TINY,
                            mesh=_cpu_mesh(sequence=4, tensor=2),
                            use_ring=use_ring)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


SEQ_AXES = dict(data=1, fsdp=2, sequence=2, tensor=2)


@pytest.fixture
def jflash_ring(monkeypatch):
    """The reference's model calls ``ring_attention`` with ``impl="auto"``,
    its einsum form on the CPU, whose dq and dk are not plain attention's
    (see ``test_xla_form_grads_match_plain_attention``): its gradients and
    train steps are taken through its flash form (its TPU path, Pallas in
    interpret mode) instead. The reference package is not changed."""
    monkeypatch.setattr(jllama, "ring_attention", functools.partial(
        jring_mod.ring_attention, impl="flash"))


@pytest.mark.parametrize("remat", [False, True])
def test_sequence_parallel_loss_and_grads(tiny, remat, jflash_ring):
    """``loss_fn(use_ring=True)`` and every gradient leaf on data 1 x fsdp
    2 x sequence 2 x tensor 2 against the reference's (its ring on its
    mesh) and the port's single device; remat "full" reruns the ring's
    forward in the backward."""
    jp, tp = tiny
    t = _tokens(2, 33, seed=3)
    jmesh = _jmesh(**SEQ_AXES)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(p, jnp.asarray(t), JTINY, jmesh,
                                 use_ring=True, remat=remat)))(
        jshard(jp, jmesh, jllama.param_specs(JTINY)))
    params = _map(lambda x: x.clone().requires_grad_(True), tp)
    flat = ttrain.leaves(params)
    names = list(_leaves(params))
    runs = {}
    for key, mesh in (("mesh", _cpu_mesh(**SEQ_AXES)), ("single", None)):
        loss = llama.loss_fn(params, torch.tensor(t), TINY, remat=remat,
                             mesh=mesh, use_ring=mesh is not None)
        runs[key] = (loss.item(), torch.autograd.grad(loss, flat))
    want = _leaves(jax.tree.map(np.asarray, jgrads))
    for key, (loss, grads) in runs.items():
        assert abs(loss - float(jloss)) < 1e-5, key
        for name, g in zip(names, grads):
            np.testing.assert_allclose(g.numpy(), want[name], atol=1e-5,
                                       rtol=1e-4, err_msg=f"{key} {name}")


def test_sequence_parallel_train_steps(tiny, jflash_ring):
    """The twin of ``test_sequence_parallel_train_step``: three AdamW
    steps of ``make_train_step(mesh=, use_ring=True)`` on data 1 x fsdp 2
    x sequence 2 x tensor 2 against three of the reference's on its mesh
    and three of the port's single-device step."""
    jmesh = _jmesh(**SEQ_AXES)
    toks = _tokens(2, 33, seed=2)
    jopt = jtrain.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=100)
    jstate = jtrain.init_train_state(JTINY, jmesh, jopt, seed=0)
    np_params = jax.tree.map(np.asarray, jstate.params)
    jstep = jtrain.make_train_step(JTINY, jmesh, jopt, use_ring=True)
    jlosses = []
    for _ in range(3):
        jstate, loss = jstep(jstate, jnp.asarray(toks))
        jlosses.append(float(loss))
    mu = _leaves(jax.tree.map(
        np.asarray, optax.tree_utils.tree_get(jstate.opt_state, "mu")))
    jparams = _leaves(jax.tree.map(np.asarray, jstate.params))
    for mesh in (_cpu_mesh(**SEQ_AXES), None):
        opt = ttrain.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=100)
        state = ttrain.train_state_from_params(
            params_from_numpy(np_params, TINY, device="cpu"), opt, mesh=mesh)
        step = ttrain.make_train_step(TINY, opt, device="cpu", mesh=mesh,
                                      use_ring=mesh is not None)
        losses = []
        for _ in range(3):
            state, loss = step(state, torch.tensor(toks))
            losses.append(loss.item())
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-5)
        got_mu = _leaves(state.opt_state.mu)
        for name, want in mu.items():
            np.testing.assert_allclose(got_mu[name].numpy(), want, atol=1e-4,
                                       rtol=1e-3, err_msg=name)
        for name, got in _leaves(state.params).items():
            np.testing.assert_allclose(got.detach().numpy(), jparams[name],
                                       atol=5e-4, rtol=5e-4, err_msg=name)


def test_moe_loss_with_ring_on_data_x_sequence():
    """An MoE ``loss_fn(use_ring=True)`` on data 2 x sequence 2 against
    the reference's on its mesh: the MoE block runs on each group's whole
    sequence, so routing and the aux's means are the global ones."""
    jcfg = dataclasses.replace(jmoe.MOE_PRESETS["tiny-moe"],
                               moe_impl="einsum")
    tcfg = dataclasses.replace(moe.MOE_PRESETS["tiny-moe"],
                               moe_impl="einsum")
    jp = jmoe.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    t = _tokens(4, 33, vocab=tcfg.vocab_size, seed=5)
    jmesh = _jmesh(data=2, sequence=2)
    jloss = float(jax.jit(lambda p: jmoe.loss_fn(
        p, jnp.asarray(t), jcfg, mesh=jmesh, use_ring=True))(
            jshard(jp, jmesh, jmoe.param_specs(jcfg))))
    mesh = _cpu_mesh(data=2, sequence=2)
    loss = moe.loss_fn(tp, torch.tensor(t), tcfg, mesh=mesh, use_ring=True)
    assert abs(loss.item() - jloss) < 1e-5
    single = moe.loss_fn(tp, torch.tensor(t), tcfg)
    assert abs(loss.item() - single.item()) < 1e-5
    _, aux = moe.forward(tp, torch.tensor(t[:, :-1]), tcfg, mesh=mesh,
                         use_ring=True)
    _, jaux = jmoe.forward(jp, jnp.asarray(t[:, :-1]), jcfg)
    assert abs(aux.item() - float(jaux)) < 1e-5
