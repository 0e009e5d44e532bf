"""The port's ring hop (``parallel/ring.py::ring_permute``) against the
JAX package's, the twin of ``tests/test_moe_dispatch.py::TestRingPermute``.

The reference runs ``ring_permute`` inside a ``shard_map`` over a 4-shard
``expert`` mesh of conftest's virtual CPU devices, with its Pallas kernel
K9 in interpret mode (``impl="pallas"``) and with ``lax.ppermute``
(``impl="xla"``). The port calls it once with the list of the 4 shards'
buffers (a single-controller mesh of 4 CPU shards), where it runs its
plain version. Rotations and gradients must agree exactly; the collective
ledger must record the same bytes at the same site. A group of rings
(``ring_permute_many``: the EP hop's bf16 chunk beside its f32 carrier,
one launch on the card) must equal the plain version ring by ring, its
gradient the group's inverse rotation, its ledger records one call's a
ring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.parallel import collectives as jcoll
from k8s_dra_driver_tpu.parallel import ring as jring
from k8s_dra_driver_tpu.parallel.compat import shard_map_compat
from k8s_dra_driver_tpu_torch.parallel import (
    MeshConfig,
    build_mesh,
    collectives,
    ring,
)

N = 4
JP = jax.sharding.PartitionSpec


def _jmesh():
    return jax.make_mesh((N,), ("expert",))


def _ref_rotate(x: np.ndarray, shift: int, impl: str) -> np.ndarray:
    fn = shard_map_compat(
        lambda xs: jring.ring_permute(
            xs[0], "expert", N, shift=shift, impl=impl, interpret=True,
        )[None],
        mesh=_jmesh(), in_specs=JP("expert"), out_specs=JP("expert"),
        check_vma=False,
    )
    return np.asarray(jax.jit(fn)(jnp.asarray(x)))


def _ref_grad(x: np.ndarray, w: np.ndarray, shift: int,
              impl: str) -> np.ndarray:
    def loss(xs):
        fn = shard_map_compat(
            lambda a, b: (jring.ring_permute(
                a[0], "expert", N, shift=shift, impl=impl, interpret=True,
            )[None] * b).sum()[None],
            mesh=_jmesh(), in_specs=(JP("expert"), JP("expert")),
            out_specs=JP("expert"), check_vma=False,
        )
        return fn(xs, jnp.asarray(w)).sum()

    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(x)))


def _shards(x: np.ndarray, **kw) -> list:
    return [torch.tensor(x[i], **kw) for i in range(N)]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shift", [1, -1, 3])
def test_rotation_equals_the_reference(impl, shift):
    x = np.arange(N * 8 * 16, dtype=np.float32).reshape(N, 8, 16)
    want = _ref_rotate(x, shift, impl)
    np.testing.assert_array_equal(want, np.roll(x, shift, axis=0))
    out = ring.ring_permute(_shards(x), "expert", N, shift=shift, impl=impl)
    np.testing.assert_array_equal(np.stack([o.numpy() for o in out]), want)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shift", [1, -1, 3])
def test_gradient_is_the_inverse_rotation(impl, shift):
    x = np.arange(N * 4 * 8, dtype=np.float32).reshape(N, 4, 8)
    w = np.random.RandomState(16).randn(N, 4, 8).astype(np.float32)
    want = _ref_grad(x, w, shift, impl)
    np.testing.assert_array_equal(want, np.roll(w, -shift, axis=0))
    xs = _shards(x, requires_grad=True)
    out = ring.ring_permute(xs, "expert", N, shift=shift, impl=impl)
    sum((o * torch.from_numpy(w[i])).sum() for i, o in enumerate(out)
        ).backward()
    np.testing.assert_array_equal(np.stack([t.grad.numpy() for t in xs]),
                                  want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8,
                                   torch.float32])
def test_ledger_bytes_equal_the_reference(dtype):
    """One hop records permute_bytes(one shard's payload, n) at its site,
    the reference's record for the same hop."""
    x = np.ones((N, 8, 16), np.float32)
    jdtype = {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8,
              torch.float32: jnp.float32}[dtype]
    jled = jcoll.CollectiveLedger()
    jled.install()
    try:
        fn = shard_map_compat(
            lambda xs: jring.ring_permute(
                xs[0], "expert", N, site="moe.ep_ring.x")[None],
            mesh=_jmesh(), in_specs=JP("expert"), out_specs=JP("expert"),
            check_vma=False,
        )
        jax.jit(fn)(jnp.asarray(x, jdtype))
    finally:
        jled.uninstall()
    led = collectives.CollectiveLedger()
    led.install()
    try:
        ring.ring_permute([t.to(dtype) for t in _shards(x)], "expert", N,
                          site="moe.ep_ring.x")
    finally:
        led.uninstall()
    assert led.snapshot() == jled.snapshot() == [{
        "site": "moe.ep_ring.x", "medium": "ici",
        "bytes": N * 8 * 16 * dtype.itemsize, "invocations": 1}]


def test_kernel_wrapper_on_the_cpu_is_the_plain_version():
    """On CPU tensors the K9 wrapper runs the plain version and launches
    nothing; a ring of one copies; every impl name is taken."""
    xs = [torch.full((3, 5), float(i)) for i in range(N)]
    before = ring.ring_permute_kernel.launches
    for impl in ("auto", "xla", "pallas"):
        out = ring.ring_permute(xs, "expert", N, impl=impl)
        assert [o[0, 0].item() for o in out] == [3.0, 0.0, 1.0, 2.0]
    assert ring.ring_permute_kernel.launches == before
    one = ring.ring_permute(xs[:1], "expert", 1)
    assert torch.equal(one[0], xs[0]) and one[0] is not xs[0]
    assert ring.ring_permute_kernel(xs, 2)[0] is not xs[2]


@pytest.mark.parametrize("bad", ["impl", "count", "shape", "dtype",
                                 "too_many", "mixed_devices"])
def test_ring_permute_refuses(bad):
    xs = [torch.zeros(2, 3) for _ in range(N)]
    if bad == "impl":
        with pytest.raises(ValueError, match="impl"):
            ring.ring_permute(xs, "expert", N, impl="nccl")
    elif bad == "count":
        with pytest.raises(ValueError, match="ring of 5"):
            ring.ring_permute(xs, "expert", 5)
    elif bad == "shape":
        with pytest.raises(ValueError, match="must match"):
            ring.ring_permute(xs[:3] + [torch.zeros(3, 3)], "expert", N)
    elif bad == "dtype":
        with pytest.raises(ValueError, match="must match"):
            ring.ring_permute(xs[:3] + [torch.zeros(2, 3).double()],
                              "expert", N)
    elif bad == "too_many":
        with pytest.raises(ValueError, match="1 to 8"):
            ring.ring_permute_kernel([torch.zeros(1)] * 9, 1)
    else:
        meta = [torch.zeros(2, 3, device="meta")] + xs[1:]
        with pytest.raises(ValueError, match="CUDA device"):
            ring.ring_permute_kernel(meta, 1)


def test_build_mesh_needs_an_explicit_list_beyond_the_visible_cards():
    """Several shards on one device only from an explicit device list."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="pass devices= explicitly"):
        build_mesh(MeshConfig(expert=visible + 1))
    mesh = build_mesh(MeshConfig(expert=N), devices=["cpu"] * N)
    assert mesh.shape == {"data": 1, "fsdp": 1, "pipe": 1, "expert": N,
                          "sequence": 1, "tensor": 1}
    assert mesh.devices == (torch.device("cpu"),) * N
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        build_mesh(MeshConfig(expert=N), devices=["cpu"] * 3)


# A hop's group: the bf16 chunk [t_loc, H] and the f32 carrier beside it,
# as the EP ring body rotates them in one launch.
def _group(seed: int, requires_grad: bool = False) -> list:
    rng = np.random.RandomState(seed)
    chunk = rng.randn(N, 6, 16).astype(np.float32)
    carrier = rng.randn(N, 6, 16).astype(np.float32)
    return [
        [torch.tensor(chunk[i]).to(torch.bfloat16).requires_grad_(
            requires_grad) for i in range(N)],
        [torch.tensor(carrier[i], requires_grad=requires_grad)
         for i in range(N)],
    ]


@pytest.mark.parametrize("shift", [1, -1, 3])
def test_group_rotation_equals_the_plain_version_ring_by_ring(shift):
    """``ring_permute_many`` on a bf16 ring and an f32 ring equals
    ``ring_permute_reference`` of each ring, bit for bit, and numpy's
    roll; ``ring_permute_group`` (the kernel's entry) takes the plain
    version on CPU tensors and launches nothing."""
    rings = _group(shift + 10)
    before = ring.ring_permute_kernel.launches
    got = ring.ring_permute_many(rings, "expert", N, shift=shift,
                                 sites=("moe.ep_ring.x", "moe.ep_ring.y"))
    direct = ring.ring_permute_group(rings, shift % N)
    assert ring.ring_permute_kernel.launches == before
    for out, same, xs in zip(got, direct, rings):
        want = ring.ring_permute_reference(xs, shift)
        assert [o.dtype for o in out] == [x.dtype for x in xs]
        for o, s, w in zip(out, same, want):
            assert torch.equal(o.view(torch.uint8), w.view(torch.uint8))
            assert torch.equal(s.view(torch.uint8), w.view(torch.uint8))
        np.testing.assert_array_equal(
            np.stack([o.float().numpy() for o in out]),
            np.roll(np.stack([x.float().numpy() for x in xs]), shift, axis=0))


@pytest.mark.parametrize("shift", [1, -1, 3])
def test_group_gradient_is_the_inverse_group_rotation(shift):
    """The group's gradient is each ring's inverse rotation of its
    cotangents (``RingPermuteFunction`` over the group)."""
    rings = _group(shift + 20, requires_grad=True)
    w = [[torch.randn(6, 16, generator=torch.Generator().manual_seed(
        10 * r + i)) for i in range(N)] for r in range(2)]
    got = ring.ring_permute_many(rings, "expert", N, shift=shift,
                                 sites=("a", "b"))
    assert all(o.requires_grad for out in got for o in out)
    sum((o.float() * wi).sum() for out, ws in zip(got, w)
        for o, wi in zip(out, ws)).backward()
    for xs, ws in zip(rings, w):
        want = ring.ring_permute_reference(
            [wi.to(xs[0].dtype) for wi in ws], -shift)
        for x, g in zip(xs, want):
            assert x.grad.dtype == x.dtype and torch.equal(x.grad, g)


def test_group_ledger_records_equal_single_ring_calls():
    """A group records, ring by ring, what one ``ring_permute`` call a ring
    records: the EP hop's ``moe.ep_ring.x`` then ``moe.ep_ring.y``."""
    sites = ("moe.ep_ring.x", "moe.ep_ring.y")
    records = []
    for grouped in (True, False):
        led = collectives.CollectiveLedger()
        led.install()
        try:
            rings = _group(5)
            if grouped:
                ring.ring_permute_many(rings, "expert", N, sites=sites)
            else:
                for xs, site in zip(rings, sites):
                    ring.ring_permute(xs, "expert", N, site=site)
        finally:
            led.uninstall()
        records.append(led.snapshot())
    assert records[0] == records[1] == [
        {"site": "moe.ep_ring.x", "medium": "ici",
         "bytes": N * 6 * 16 * 2, "invocations": 1},
        {"site": "moe.ep_ring.y", "medium": "ici",
         "bytes": N * 6 * 16 * 4, "invocations": 1}]


@pytest.mark.parametrize("bad", ["sites", "ring_sizes", "empty"])
def test_group_refuses(bad):
    rings = _group(6)
    if bad == "sites":
        with pytest.raises(ValueError, match="1 sites for 2 rings"):
            ring.ring_permute_many(rings, "expert", N, sites=("x",))
    elif bad == "ring_sizes":
        with pytest.raises(ValueError, match="share one axis"):
            ring.ring_permute_group([rings[0], rings[1][:2]], 1)
    else:
        with pytest.raises(ValueError, match="no ring"):
            ring.ring_permute_group([], 1)
