"""The port's ops against the JAX package's, on the CPU.

Same seeded numpy inputs through both: the JAX function (its Pallas
kernel in interpret mode, and its plain reference) and the port's
counterpart, which on CPU tensors runs its plain PyTorch version. The
CUDA kernels themselves are held against the same plain versions on the
card (``tests/test_torch_kernels.py``, and ``chip_smoke.py`` at
Llama-3-8B shapes).

Tolerances: f32 throughout; RMSNorm and RoPE at atol 1e-6 / rtol 1e-5
(the same f32 formula; RMSNorm gradients 1e-5), paged and flash
attention at atol 2e-5 (the softmax and the two contractions sum in a
different order), flash gradients at atol/rtol 5e-4 as in the
reference's own tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.ops import attention as jatt
from k8s_dra_driver_tpu.ops import norms as jnorms
from k8s_dra_driver_tpu.ops import rotary as jrot
from k8s_dra_driver_tpu_torch.ops import attention as tatt
from k8s_dra_driver_tpu_torch.ops import norms as tnorms
from k8s_dra_driver_tpu_torch.ops import rotary as trot

ATT_TOL = dict(atol=2e-5, rtol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


class TestRmsnorm:
    @pytest.mark.parametrize("shape", [(3, 5, 64), (7, 48)])
    def test_matches_jax_kernel_and_reference(self, shape):
        rng = np.random.RandomState(0)
        x = rng.randn(*shape).astype(np.float32)
        w = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
        eps = 1e-5
        ours = tnorms.rmsnorm(_t(x), _t(w), eps).numpy()
        kernel = jnorms.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps,
                                force_pallas=True, interpret=True)
        ref = jnorms.rmsnorm_reference(jnp.asarray(x), jnp.asarray(w), eps)
        np.testing.assert_allclose(ours, np.asarray(kernel), atol=1e-6,
                                   rtol=1e-5)
        np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-6,
                                   rtol=1e-5)

    def test_cpu_path_is_not_a_launch(self):
        before = tnorms.rmsnorm.launches
        tnorms.rmsnorm(torch.ones(2, 8), torch.ones(8))
        assert tnorms.rmsnorm.launches == before

    def test_non_cpu_non_cuda_tensor_raises(self):
        """Only CPU tensors take the plain version; anything else must
        launch the kernel or raise."""
        x = torch.empty(2, 8, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            tnorms.rmsnorm(x, torch.empty(8, device="meta"))


class TestRope:
    def test_frequencies_match(self):
        cos, sin = trot.rope_frequencies(16, 40, 500000.0, device="cpu")
        jcos, jsin = jrot.rope_frequencies(16, 40, 500000.0)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6,
                                   rtol=1e-5)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6,
                                   rtol=1e-5)

    @pytest.mark.parametrize("layout", ["none", "shared", "per_seq"])
    def test_apply_matches(self, layout):
        rng = np.random.RandomState(1)
        b, h, s, d, span = 2, 3, 5, 16, 40
        x = rng.randn(b, h, s, d).astype(np.float32)
        positions = {
            "none": None,
            "shared": np.arange(7, 7 + s, dtype=np.int32),
            "per_seq": rng.randint(0, span, size=(b, s)).astype(np.int32),
        }[layout]
        jcos, jsin = jrot.rope_frequencies(d, span if positions is not None
                                           else s)
        tcos, tsin = trot.rope_frequencies(d, span if positions is not None
                                           else s, device="cpu")
        want = jrot.apply_rope(
            jnp.asarray(x), jcos, jsin,
            None if positions is None else jnp.asarray(positions),
        )
        got = trot.apply_rope(
            _t(x), tcos, tsin,
            None if positions is None else _t(positions),
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-5)


def _pools(rng, hkv, nb, bs, d):
    k = rng.randn(hkv, nb * bs, d).astype(np.float32)
    v = rng.randn(hkv, nb * bs, d).astype(np.float32)
    return k, v


class TestPagedDecode:
    """One query token per sequence, GQA G=2, ragged valid_len (one row,
    a block boundary + 3, the whole span)."""

    def _setup(self, seed=0):
        rng = np.random.RandomState(seed)
        b, hq, hkv, d, bs, nb, nbps = 3, 4, 2, 16, 8, 12, 4
        q = rng.randn(b, hq, d).astype(np.float32)
        k, v = _pools(rng, hkv, nb, bs, d)
        tables = rng.permutation(nb)[: b * nbps].reshape(b, nbps).astype(
            np.int32)
        vlen = np.array([1, bs * 2 + 3, bs * nbps], np.int32)
        return q, k, v, tables, vlen, bs

    def test_matches_jax_kernel_and_reference(self):
        q, k, v, tables, vlen, bs = self._setup()
        ours = tatt.paged_decode_attention(
            _t(q), _t(k), _t(v), _t(tables), _t(vlen), bs).numpy()
        kernel = jatt.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(vlen), bs,
            force_pallas=True, interpret=True)
        ref = jatt.paged_attention_reference(
            jnp.asarray(q)[:, :, None], jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(vlen - 1)[:, None], bs,
        )[:, :, 0]
        np.testing.assert_allclose(ours, np.asarray(kernel), **ATT_TOL)
        np.testing.assert_allclose(ours, np.asarray(ref), **ATT_TOL)

    def test_reference_matches_jax_reference_any_positions(self):
        """The plain version at arbitrary (non-contiguous) positions."""
        rng = np.random.RandomState(5)
        q, k, v, tables, _, bs = self._setup(seed=5)
        q4 = rng.randn(3, 4, 3, 16).astype(np.float32)
        positions = np.array([[0, 9, 4], [31, 2, 17], [5, 5, 30]], np.int32)
        ours = tatt.paged_attention_reference(
            _t(q4), _t(k), _t(v), _t(tables), _t(positions), bs).numpy()
        ref = jatt.paged_attention_reference(
            jnp.asarray(q4), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(positions), bs)
        np.testing.assert_allclose(ours, np.asarray(ref), **ATT_TOL)


class TestPagedPrefill:
    """Contiguous windows: a start > 0 straddling a block boundary, T=1,
    and a full chunk from position 0, against JAX's kernel (interpret
    mode) and reference."""

    @pytest.mark.parametrize("t,starts", [
        (12, (0, 7, 37)),        # start 7: the window straddles bs=16
        (1, (0, 9, 30)),         # one remaining prompt token
        (16, (0, 0, 0)),         # a full chunk of a fresh prompt
    ])
    def test_matches_jax_kernel_and_reference(self, t, starts):
        rng = np.random.RandomState(0)
        b, hq, hkv, d, bs, nb, nbps = 3, 4, 2, 16, 16, 14, 4
        q = rng.randn(b, hq, t, d).astype(np.float32)
        k, v = _pools(rng, hkv, nb, bs, d)
        tables = rng.permutation(nb)[: b * nbps].reshape(b, nbps).astype(
            np.int32)
        positions = (np.array(starts, np.int32)[:, None]
                     + np.arange(t, dtype=np.int32)[None, :])
        ours = tatt.paged_prefill_attention(
            _t(q), _t(k), _t(v), _t(tables), _t(positions), bs).numpy()
        args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(tables), jnp.asarray(positions), bs)
        kernel = jatt.paged_prefill_attention(*args, force_pallas=True,
                                              interpret=True)
        ref = jatt.paged_attention_reference(*args)
        np.testing.assert_allclose(ours, np.asarray(kernel), **ATT_TOL)
        np.testing.assert_allclose(ours, np.asarray(ref), **ATT_TOL)

    def test_padded_rows_stay_finite(self):
        """A right-padded window whose tail runs past every written row
        (sentinel table entries, zero pool rows): the padded queries'
        outputs are discarded by the caller but must be finite, and the
        valid rows must not change when the padded tail's kv is garbage."""
        rng = np.random.RandomState(2)
        b, hq, hkv, d, bs, nb, nbps, t = 2, 4, 2, 16, 8, 8, 4, 8
        q = rng.randn(b, hq, t, d).astype(np.float32)
        k, v = _pools(rng, hkv, nb, bs, d)
        tables = np.zeros((b, nbps), np.int32)
        tables[0, :2] = [3, 5]
        tables[1, :1] = [6]
        positions = np.array([10, 4], np.int32)[:, None] + np.arange(t)
        n_valid = np.array([3, 4])
        out = tatt.paged_prefill_attention(
            _t(q), _t(k), _t(v), _t(tables), _t(positions), bs).numpy()
        assert np.isfinite(out).all()
        k2, v2 = k.copy(), v.copy()
        for i in range(b):
            last = positions[i, n_valid[i] - 1]
            for j in range(nbps):
                for r in range(bs):
                    if j * bs + r > last and tables[i, j]:
                        k2[:, tables[i, j] * bs + r] = 1e4
                        v2[:, tables[i, j] * bs + r] = -1e4
        out2 = tatt.paged_prefill_attention(
            _t(q), _t(k2), _t(v2), _t(tables), _t(positions), bs).numpy()
        for i in range(b):
            np.testing.assert_array_equal(out2[i, :, : n_valid[i]],
                                          out[i, :, : n_valid[i]])

    def test_wrappers_refuse_non_cpu_tensors_without_a_card(self):
        q = torch.empty(1, 4, 2, 64, device="meta")
        pool = torch.empty(2, 16, 64, device="meta")
        tables = torch.zeros(1, 2, dtype=torch.int32, device="meta")
        pos = torch.zeros(1, 2, dtype=torch.int64, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            tatt.paged_prefill_attention(q, pool, pool, tables, pos, 8)
        with pytest.raises(ValueError, match="CUDA"):
            tatt.paged_decode_attention(
                q[:, :, 0], pool, pool, tables,
                torch.ones(1, dtype=torch.int32, device="meta"), 8)


def _int8_pools(rng, hkv, nb, bs, d):
    """int8 pools and their per-position f32 scales [H_kv, P], quantized
    by the reference's recipe (one scale per row over D)."""
    from k8s_dra_driver_tpu.models.quant import quantize_tensor

    out = []
    for pool in _pools(rng, hkv, nb, bs, d):
        qt = quantize_tensor(jnp.asarray(pool), axis=-1)
        out += [np.array(qt.q), np.array(qt.scale)[..., 0]]
    return out                                    # k, k_scale, v, v_scale


class TestPagedInt8:
    """The int8 branch (int8 pools, k scale on the scores, v scale on the
    f32 probabilities): the plain version against JAX's kernels in
    interpret mode and its reference, decode and prefill, GQA, a window
    straddling a block boundary, sentinel (0) table entries past each
    sequence's blocks."""

    def _tables(self, rng, b, nbps, nb, used):
        tables = np.zeros((b, nbps), np.int32)
        ids = rng.permutation(np.arange(1, nb))
        for i, n in enumerate(used):
            tables[i, :n] = ids[i * nbps: i * nbps + n]
        return tables

    @pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)])
    def test_decode_matches_jax_kernel_and_reference(self, hq, hkv):
        rng = np.random.RandomState(6)
        b, d, bs, nb, nbps = 3, 16, 8, 14, 4
        q = rng.randn(b, hq, d).astype(np.float32)
        k, ks, v, vs = _int8_pools(rng, hkv, nb, bs, d)
        vlen = np.array([1, bs * 2 + 3, bs * nbps], np.int32)
        tables = self._tables(rng, b, nbps, nb, [1, 3, 4])
        ours = tatt.paged_decode_attention(
            *_t_all(q, k, v, tables, vlen), bs,
            k_scale=_t(ks), v_scale=_t(vs)).numpy()
        jargs = [jnp.asarray(a) for a in (q, k, v, tables, vlen)]
        kernel = jatt.paged_decode_attention(
            *jargs, bs, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
            force_pallas=True, interpret=True)
        ref = jatt.paged_attention_reference(
            jargs[0][:, :, None], *jargs[1:4], jnp.asarray(vlen - 1)[:, None],
            bs, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))[:, :, 0]
        np.testing.assert_allclose(ours, np.asarray(kernel), **ATT_TOL)
        np.testing.assert_allclose(ours, np.asarray(ref), **ATT_TOL)

    @pytest.mark.parametrize("t,starts", [
        (12, (0, 7, 37)),        # start 7: the window straddles bs=16
        (1, (0, 9, 30)),
        (16, (0, 0, 0)),
    ])
    def test_prefill_matches_jax_kernel_and_reference(self, t, starts):
        rng = np.random.RandomState(7)
        b, hq, hkv, d, bs, nb, nbps = 3, 4, 2, 16, 16, 14, 4
        q = rng.randn(b, hq, t, d).astype(np.float32)
        k, ks, v, vs = _int8_pools(rng, hkv, nb, bs, d)
        positions = (np.array(starts, np.int32)[:, None]
                     + np.arange(t, dtype=np.int32)[None, :])
        used = [-(-(s0 + t) // bs) for s0 in starts]
        tables = self._tables(rng, b, nbps, nb, used)
        ours = tatt.paged_prefill_attention(
            *_t_all(q, k, v, tables, positions), bs,
            k_scale=_t(ks), v_scale=_t(vs)).numpy()
        args = [jnp.asarray(a) for a in (q, k, v, tables, positions)]
        scales = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        kernel = jatt.paged_prefill_attention(*args, bs, **scales,
                                              force_pallas=True,
                                              interpret=True)
        ref = jatt.paged_attention_reference(*args, bs, **scales)
        np.testing.assert_allclose(ours, np.asarray(kernel), **ATT_TOL)
        np.testing.assert_allclose(ours, np.asarray(ref), **ATT_TOL)
        np.testing.assert_array_equal(
            tatt.paged_prefill_int8(*_t_all(q, k, v), _t(ks), _t(vs),
                                    *_t_all(tables, positions), bs).numpy(),
            ours)

    def test_int8_wrappers_count_apart_and_refuse_without_a_card(self):
        before = (tatt.paged_decode_attention.launches,
                  tatt.paged_decode_int8.launches)
        rng = np.random.RandomState(8)
        k, ks, v, vs = _int8_pools(rng, 2, 4, 8, 16)
        q = torch.from_numpy(rng.randn(1, 4, 16).astype(np.float32))
        tables = torch.tensor([[1, 2]], dtype=torch.int32)
        vlen = torch.tensor([9], dtype=torch.int32)
        tatt.paged_decode_attention(q, _t(k), _t(v), tables, vlen, 8,
                                    k_scale=_t(ks), v_scale=_t(vs))
        assert (tatt.paged_decode_attention.launches,
                tatt.paged_decode_int8.launches) == before
        meta = dict(device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            tatt.paged_decode_int8(
                torch.empty(1, 4, 64, **meta),
                torch.empty(2, 16, 64, dtype=torch.int8, **meta),
                torch.empty(2, 16, 64, dtype=torch.int8, **meta),
                torch.empty(2, 16, **meta), torch.empty(2, 16, **meta),
                torch.zeros(1, 2, dtype=torch.int32, **meta),
                torch.ones(1, dtype=torch.int32, **meta), 8)


def _t_all(*arrays):
    return [_t(a) for a in arrays]


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, s, d).astype(np.float32),
            rng.randn(b, hkv, s, d).astype(np.float32),
            rng.randn(b, hkv, s, d).astype(np.float32))


FLASH_CASES = [  # (causal, Hq, H_kv): G = 1 and G = 2, causal and not
    (True, 4, 2), (True, 2, 2), (False, 4, 2), (False, 2, 2),
]


class TestFlashAttention:
    """The flash half's plain versions against the Pallas kernels in
    interpret mode at S=64 with 16-row blocks (several q and kv blocks,
    the diagonal straddle and the skipped blocks). Tolerance, f32: out and
    lse atol 2e-5; gradients atol/rtol 5e-4, as the reference's own
    flash-gradient tests."""

    B, S, D, BLOCK = 2, 64, 16, 16

    @pytest.mark.parametrize("causal,hq,hkv", FLASH_CASES)
    def test_forward_and_lse_match_pallas(self, causal, hq, hkv):
        q, k, v = _qkv(0, self.B, hq, hkv, self.S, self.D)
        scale = self.D ** -0.5
        jout, jlse = jatt._flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
            block_q=self.BLOCK, block_k=self.BLOCK, interpret=True,
            return_lse=True)
        out, lse = tatt.flash_attention_forward(
            _t(q), _t(k), _t(v), causal, scale, return_lse=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **ATT_TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **ATT_TOL)

    @pytest.mark.parametrize("causal,hq,hkv", FLASH_CASES[:2] + FLASH_CASES[2:3])
    def test_backward_matches_pallas(self, causal, hq, hkv):
        q, k, v = _qkv(1, self.B, hq, hkv, self.S, self.D)
        do = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
        scale = self.D ** -0.5
        args = [jnp.asarray(x) for x in (q, k, v)]
        jout, jlse = jatt._flash_attention_pallas(
            *args, causal, scale, block_q=self.BLOCK, block_k=self.BLOCK,
            interpret=True, return_lse=True)
        want = jatt._flash_attention_bwd_pallas(
            *args, jout, jlse, jnp.asarray(do), causal, scale,
            block_q=self.BLOCK, block_k=self.BLOCK, interpret=True)
        got = tatt.flash_attention_backward(
            _t(q), _t(k), _t(v), _t(np.asarray(jout)), _t(np.asarray(jlse)),
            _t(do), causal, scale)
        for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=5e-4,
                                       rtol=5e-4, err_msg=name)

    def test_autograd_matches_jax_grad_through_flash_diff(self):
        """The model's entry and the site op under it (plain versions
        forward, autograd through plain attention backward, on the CPU),
        and the backward the site runs on the card
        (``flash_attention_backward`` on the forward's out and lse),
        against ``jax.grad`` through ``_flash_diff`` (Pallas forward and
        backward, interpret mode)."""
        hq, hkv = 4, 2
        q, k, v = _qkv(3, self.B, hq, hkv, self.S, self.D)
        w = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
        scale = self.D ** -0.5

        def jloss(q_, k_, v_):
            out = jatt._flash_diff(q_, k_, v_, True, scale, True,
                                   self.BLOCK, self.BLOCK)
            return jnp.sum(out * jnp.asarray(w))

        want = jax.grad(jloss, argnums=(0, 1, 2))(
            *[jnp.asarray(x) for x in (q, k, v)])

        def card_backward(q_, k_, v_):
            out, lse = tatt.flash_attention_forward(q_, k_, v_, True, scale,
                                                    return_lse=True)
            return tatt.flash_attention_backward(q_, k_, v_, out, lse, _t(w),
                                                 True, scale)

        for fn in (lambda *a: tatt.flash_attention(*a, causal=True),
                   lambda *a: tatt.flash_site(*a, True, scale)[0]):
            leaves = [_t(x).requires_grad_() for x in (q, k, v)]
            loss = (fn(*leaves) * _t(w)).sum()
            got = torch.autograd.grad(loss, leaves)
            for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b_),
                                           atol=5e-4, rtol=5e-4,
                                           err_msg=name)
        got = card_backward(*[_t(x) for x in (q, k, v)])
        for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_),
                                       atol=5e-4, rtol=5e-4, err_msg=name)

    def test_attention_reference_causal_offset_matches_jax(self):
        """sq < skv: query i sees kv positions <= i + skv - sq."""
        rng = np.random.RandomState(5)
        q = rng.randn(1, 2, 5, 8).astype(np.float32)
        k = rng.randn(1, 2, 9, 8).astype(np.float32)
        v = rng.randn(1, 2, 9, 8).astype(np.float32)
        want = jatt.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True)
        got = tatt.attention_reference(_t(q), _t(k), _t(v), causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)

    def test_wrappers_refuse_non_cpu_tensors_without_a_card(self):
        q = torch.empty(1, 4, 8, 64, device="meta", dtype=torch.bfloat16)
        kv = torch.empty(1, 2, 8, 64, device="meta", dtype=torch.bfloat16)
        rows = torch.empty(1, 4, 8, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            tatt.flash_fwd(q, kv, kv)
        with pytest.raises(ValueError, match="CUDA"):
            tatt.flash_bwd_dkdv(q, kv, kv, q, rows, rows)
        with pytest.raises(ValueError, match="CUDA"):
            tatt.flash_bwd_dq(q, kv, kv, q, rows, rows)


def test_rmsnorm_function_grads_match_jax_vjp():
    """The autograd.Function the card runs (its forward takes the plain
    version on CPU tensors) and the CPU entry both give the reference's
    ``jax.vjp`` of ``rmsnorm_reference``."""
    rng = np.random.RandomState(6)
    x = rng.randn(3, 5, 32).astype(np.float32)
    w = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    g = rng.randn(3, 5, 32).astype(np.float32)
    eps = 1e-5
    _, vjp = jax.vjp(lambda a, b: jnorms.rmsnorm_reference(a, b, eps),
                     jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(g))
    for fn in (tnorms.rmsnorm, tnorms.RMSNormFunction.apply):
        xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
        got = torch.autograd.grad(fn(xt, wt, eps), (xt, wt), _t(g))
        for a, b_ in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=1e-5,
                                       rtol=1e-5)


def _bf16_close(name, got, want):
    """bf16 results against the reference's: the largest error within 2%
    of the largest value, the mean error within 1% of the mean value (the
    two round to bf16 at other places)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert err.max() <= 2e-2 * np.abs(want).max(), (name, err.max())
    assert err.mean() <= 1e-2 * np.abs(want).mean(), (name, err.mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 4096), (1, 1000), (3, 5, 1000),
                                   (4, 4096)])
def test_rmsnorm_backward_reference_matches_jax_vjp(shape, dtype):
    """The gradient's closed form (the plain version the card's gradient
    kernel is held to) against ``jax.vjp`` of the reference's
    ``rmsnorm_reference``: one row and several, widths 1000 and 4096; f32
    to 1e-5, bf16 by the 2% / 1% rule."""
    rng = np.random.RandomState(7)
    x = rng.randn(*shape).astype(np.float32)
    w = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    eps = 1e-5
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jw, jg = (jnp.asarray(a).astype(jdt) for a in (x, w, g))
    _, vjp = jax.vjp(lambda a, b: jnorms.rmsnorm_reference(a, b, eps), jx, jw)
    want = vjp(jg)
    got = tnorms.rmsnorm_backward_reference(
        *(_t(a).to(tdt) for a in (x, w, g)), eps)
    assert got[0].dtype == got[1].dtype == tdt
    assert got[0].shape == x.shape and got[1].shape == w.shape
    for name, a, b_ in zip(("dx", "dw"), got, want):
        a, b_ = a.float().numpy(), np.asarray(b_.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a, b_, atol=1e-5, rtol=1e-5)
        else:
            _bf16_close(name, a, b_)


def test_rmsnorm_backward_cpu_path_is_not_a_launch():
    """CPU tensors take the closed form, whether called directly or as the
    ``RMSNormFunction``'s backward; no launch is counted."""
    before = (tnorms.rmsnorm.launches, tnorms.rmsnorm_backward.launches)
    x = torch.randn(2, 8, requires_grad=True)
    w = torch.ones(8, requires_grad=True)
    tnorms.RMSNormFunction.apply(x, w, 1e-6).sum().backward()
    tnorms.rmsnorm_backward(x.detach(), w.detach(), torch.ones(2, 8))
    assert (tnorms.rmsnorm.launches,
            tnorms.rmsnorm_backward.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tnorms.rmsnorm_backward(torch.empty(2, 8, device="meta"),
                                torch.empty(8, device="meta"),
                                torch.empty(2, 8, device="meta"))
