"""The split-KV decode's plain version and its host split plan, on the CPU.

``csrc/paged_attention.cu``'s decode kernel splits each sequence's kv axis
into S splits and merges their (m, l, acc) partials in split order.
``paged_decode_split_reference`` (``paged_decode_partials`` then
``merge_partials``) is that algorithm in plain PyTorch; the card holds the
kernel against it (``tests/test_torch_kernels.py``). Here it is held, on
the same seeded numpy inputs, against the JAX package's
``paged_attention_reference`` in f32 to 1e-5 (one softmax, where the split
version takes S and merges them: the same f32 sums in another order), for
f32, bf16-valued and int8 pools, S from 1 to more splits than the span has
blocks. The host plan ``decode_splits`` is plain Python over host
integers.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.ops import attention as jatt
from k8s_dra_driver_tpu_torch.ops import attention as tatt

TOL = dict(atol=1e-5, rtol=1e-5)


def _problem(seed, pool, b=3, hq=8, hkv=2, d=16, bs=8, nbps=6):
    """q f32; pools f32, bf16-valued f32 or int8 with f32 per-position
    scales (symmetric over D); scrambled tables with spare blocks."""
    rng = np.random.RandomState(seed)
    nb = b * nbps + 2
    q = rng.randn(b, hq, d).astype(np.float32)
    k = rng.randn(hkv, nb * bs + 1, d).astype(np.float32)
    v = rng.randn(hkv, nb * bs + 1, d).astype(np.float32)
    scales = {}
    if pool == "bf16":
        k = torch.from_numpy(k).bfloat16().float().numpy()
        v = torch.from_numpy(v).bfloat16().float().numpy()
    elif pool == "int8":
        def quantize(x):
            s = np.abs(x).max(-1) / 127.0
            return np.round(x / s[..., None]).astype(np.int8), \
                s.astype(np.float32)
        (k, ks), (v, vs) = quantize(k), quantize(v)
        scales = dict(k_scale=ks, v_scale=vs)
    tables = rng.permutation(nb)[: b * nbps].reshape(b, nbps).astype(np.int32)
    return q, k, v, tables, scales, bs


def _torch(scales):
    return {n: torch.from_numpy(a) for n, a in scales.items()}


def _jax_ref(q, k, v, tables, vlen, bs, scales):
    out = jatt.paged_attention_reference(
        jnp.asarray(q)[:, :, None], jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), jnp.asarray(vlen - 1)[:, None], bs,
        **{n: jnp.asarray(a) for n, a in scales.items()})
    return np.asarray(out)[:, :, 0]


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 64])
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_split_reference_matches_jax_reference(pool, splits):
    """Lengths 1, on a block edge, one past a 32-position split edge and
    the whole span (48); 64 splits is more than the 6 blocks a sequence
    has, so most splits are empty."""
    q, k, v, tables, scales, bs = _problem(1, pool)
    vlen = np.array([1, 16, 33], np.int32)
    ours = tatt.paged_decode_split_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(vlen), bs, splits,
        **_torch(scales)).numpy()
    ref = _jax_ref(q, k, v, tables, vlen, bs, scales)
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_split_reference_matches_at_the_whole_span(pool):
    q, k, v, tables, scales, bs = _problem(2, pool, b=2, nbps=40)
    vlen = np.array([320, 257], np.int32)    # the span; a split edge + 1
    for splits in (1, 5, 9, 33):
        ours = tatt.paged_decode_split_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(tables), torch.from_numpy(vlen), bs, splits,
            **_torch(scales)).numpy()
        ref = _jax_ref(q, k, v, tables, vlen, bs, scales)
        np.testing.assert_allclose(ours, ref, **TOL)


def test_empty_splits_are_the_empty_partial():
    """Splits wholly past valid_len: m = -inf, l = 0, acc = 0; a sequence
    with valid_len 0 merges to 0, as the kernel writes it."""
    q, k, v, tables, _, bs = _problem(3, "f32")
    vlen = torch.tensor([0, 5, 40], dtype=torch.int32)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(tables), vlen, bs)
    m, l, acc = tatt.paged_decode_partials(*args, 4)
    # Split lengths: 0 -> 0 (all empty), 5 -> 32 (split 0 only), 40 -> 32.
    assert torch.equal(tatt.decode_split_len(vlen, 4),
                       torch.tensor([0, 32, 32]))
    empty = torch.tensor([[1, 1, 1, 1], [0, 1, 1, 1], [0, 0, 1, 1]],
                         dtype=torch.bool)[:, None, :].expand_as(m)
    assert torch.all(m[empty] == -torch.inf)
    assert torch.all(l[empty] == 0)
    assert torch.all(acc[empty] == 0)
    assert torch.all(torch.isfinite(m[~empty])) and torch.all(l[~empty] > 0)
    out = tatt.merge_partials(m, l, acc)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out).all()


def test_merge_weighs_each_split_by_its_max():
    """Two splits of one row: the merge rescales each by 2^(m_i - M)."""
    m = torch.tensor([[[1.0, 3.0, -torch.inf]]])
    l = torch.tensor([[[2.0, 1.0, 0.0]]])
    acc = torch.tensor([[[[4.0], [1.0], [0.0]]]])
    out = tatt.merge_partials(m, l, acc)
    want = (4.0 * 0.25 + 1.0) / (2.0 * 0.25 + 1.0)
    assert out.shape == (1, 1, 1)
    assert abs(out.item() - want) < 1e-6


def test_split_plan_reads_host_integers_only():
    """S from B, H_kv, NBPS, block_size and the SM count: at least two
    (sequence, kv head, split) blocks an SM, no split shorter than 64
    positions of the span, at least 1."""
    params = list(inspect.signature(tatt.decode_splits).parameters)
    assert params == ["b", "hkv", "nbps", "block_size", "sm_count"]
    assert tatt.decode_splits(8, 8, 512, 16, 132) == 5     # 8B's decode step
    assert tatt.decode_splits(1, 8, 512, 16, 132) == 33    # one sequence
    assert tatt.decode_splits(64, 8, 512, 16, 132) == 1    # a full card
    assert tatt.decode_splits(1, 8, 4, 16, 132) == 1       # a 64-token span
    assert tatt.decode_splits(1, 8, 5, 16, 132) == 2
    assert tatt.decode_splits(1, 1, 512, 16, 132) == 128   # the span's cap
    assert tatt.decode_splits(0, 8, 512, 16, 132) == 128   # no sequences
    for b in range(1, 40):
        assert tatt.decode_splits(b, 8, 512, 16, 132) >= \
            tatt.decode_splits(b + 1, 8, 512, 16, 132)


def test_split_lengths_are_aligned_and_cover_valid_len():
    vlen = torch.tensor([0, 1, 31, 32, 33, 396, 8191], dtype=torch.int32)
    for splits in (1, 5, 33):
        length = tatt.decode_split_len(vlen, splits)
        assert torch.all(length % tatt.DECODE_SPLIT_ALIGN == 0)
        assert torch.all(length * splits >= vlen.long())
    assert tatt.decode_split_len(vlen, 33)[-1].item() == 256
    assert tatt.decode_split_len(vlen, 5)[-2].item() == 96
