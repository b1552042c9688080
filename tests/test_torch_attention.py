"""Port parity: decode attention (K4) and the sampling filters.

On the CPU ``decode_attention`` runs its plain version; the JAX side runs
the Pallas kernel in interpret mode (``_pallas_attention(...,
interpret=True)``) and its plain ``_naive_masked_attention``, on every case
of tests/test_attention.py (a prefix of the cache, the full cache, odd
shapes, a key mask, several kv blocks, garbage past ``kv_len``) plus an
all-masked row. Bound rtol/atol 1e-5; measured max abs error ≤ 3.0e-7.
The CUDA kernel itself is held against the plain version by the
``cuda``-marked test (skipped without a card) and by ``chip_smoke.py``.

Sampling: the top-k / top-p masks equal JAX's exactly, ``argmax(lg +
jax.random.gumbel(k, lg.shape))`` is ``jax.random.categorical(k, lg)`` (so
injecting the noise is exact), and the port's sample with that noise
equals it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.ops.attention import _naive_masked_attention, _pallas_attention
from hyperscalees_t2i_tpu.ops.sampling import filter_top_k as jfilter_top_k
from hyperscalees_t2i_tpu.ops.sampling import filter_top_p as jfilter_top_p
from hyperscalees_t2i_tpu.ops.sampling import sample_top_k_top_p as jsample
from hyperscalees_t2i_tpu_torch.ops.attention import MAX_HEAD_DIM, _check, decode_attention, naive_masked_attention
from hyperscalees_t2i_tpu_torch.ops.sampling import filter_top_k, filter_top_p, sample_top_k_top_p
from hyperscalees_t2i_tpu_torch.utils import threefry

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)

# (B, nq, L, H, dh, kv_len, mask lengths or None, block_q, block_kv)
CASES = {
    "prefix": (2, 4, 16, 2, 8, 7, None, 4, 512),
    "full": (1, 16, 16, 1, 8, 16, None, 4, 512),
    "odd_shapes": (2, 5, 12, 3, 4, 9, None, 4, 512),
    "key_mask": (2, 3, 10, 2, 8, 10, (4, 10), 8, 512),
    "multi_kv_block_4": (2, 6, 20, 2, 8, 17, (13, 20), 4, 4),
    "multi_kv_block_8": (2, 6, 20, 2, 8, 17, (13, 20), 4, 8),
    "all_masked_row": (2, 3, 8, 2, 8, 8, (0, 5), 4, 4),
}


def _inputs(case, seed=0):
    B, nq, L, H, dh, kv_len, lens, _, _ = CASES[case]
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=s).astype(np.float32) for s in ((B, nq, H, dh), (B, L, H, dh), (B, L, H, dh)))
    mask = None if lens is None else (np.arange(L)[None, :] < np.asarray(lens)[:, None])
    return q, k, v, kv_len, mask


def _port(q, k, v, kv_len, mask, scale):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return decode_attention(t(q), t(k), t(v), kv_len=kv_len, kv_mask=t(mask), sm_scale=scale).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_attention_matches_jax_kernel_and_plain_path(case):
    q, k, v, kv_len, mask = _inputs(case)
    bq, bkv = CASES[case][-2:]
    scale = 1.0 / math.sqrt(q.shape[-1])
    got = _port(q, k, v, kv_len, mask, scale)
    jmask = None if mask is None else jnp.asarray(mask)
    naive = np.asarray(_naive_masked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len, jmask, scale))
    np.testing.assert_allclose(got, naive, **TOL)
    # the Pallas kernel's grid pads the sliced prefix to whole kv blocks; an
    # all-masked row then averages over that padding, so it is held against
    # the plain path only
    if case != "all_masked_row":
        kk, vv, mm = k[:, :kv_len], v[:, :kv_len], None if mask is None else jmask[:, :kv_len]
        pal = _pallas_attention(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv), kv_len, mm, scale,
                                block_q=bq, block_kv=bkv, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pal), **TOL)


def test_all_masked_row_averages_v_over_the_prefix():
    q, k, v, kv_len, mask = _inputs("all_masked_row", seed=1)
    got = _port(q, k, v, kv_len, mask, 0.5)
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0, :kv_len].mean(0), got[0].shape), **TOL)


def test_garbage_past_kv_len_is_ignored():
    q, k, v, kv_len, mask = _inputs("prefix", seed=2)
    k2, v2 = k.copy(), v.copy()
    k2[:, kv_len:], v2[:, kv_len:] = 1e6, np.nan
    np.testing.assert_array_equal(_port(q, k, v, kv_len, None, 0.3), _port(q, k2, v2, kv_len, None, 0.3))


def test_default_scale_and_length_and_bf16_dtype():
    q, k, v, _, _ = _inputs("full", seed=3)
    got = decode_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    ref = naive_masked_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), None, None,
                                 1.0 / math.sqrt(q.shape[-1]))
    assert torch.equal(got, ref)


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor off the CPU takes the kernel or raises (a meta tensor stands
    in for a card here), and the kernel's limits are checked before a
    launch: head dims up to 128, ``kv_len`` inside the cache, a bool mask."""
    before = decode_attention.launches
    q = torch.empty(1, 2, 1, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention(q, q, q)
    assert decode_attention.launches == before
    wide = torch.empty(1, 2, 1, MAX_HEAD_DIM + 1, device="meta")
    with pytest.raises(ValueError, match="head dims up to 128"):
        _check(wide, wide, wide, 2, None)
    with pytest.raises(ValueError, match="kv_len 3 outside"):
        _check(q, q, q, 3, None)
    with pytest.raises(ValueError, match="kv_mask"):
        _check(q, q, q, 2, torch.ones(1, 2, device="meta"))
    _check(q, q, q, 2, torch.ones(1, 2, dtype=torch.bool, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 37, 200, 3, 64, 150, False), (2, 70, 130, 2, 128, 130, True),
                                   (32, 256, 680, 16, 64, 680, False), (3, 9, 40, 2, 8, 23, True)])
def test_kernel_matches_plain_version_on_the_card(dtype, shape):
    """VAR-d16's last scale among the shapes, and the tiny VAR's dh 8; the
    cache holds NaN past ``kv_len``, which the kernel must never read."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    B, nq, L, H, dh, kv_len, masked = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(*s, generator=g, device="cuda").to(dt) for s in ((B, nq, H, dh), (B, L, H, dh), (B, L, H, dh)))
    k[:, kv_len:], v[:, kv_len:] = float("nan"), float("nan")
    mask = (torch.rand(B, L, generator=g, device="cuda") > 0.3) if masked else None
    before = decode_attention.launches
    out = decode_attention(q, k, v, kv_len=kv_len, kv_mask=mask)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = naive_masked_attention(q, k, v, kv_len, mask, 1.0 / math.sqrt(dh)).float()
    tol = 2 ** -7 if dt == torch.bfloat16 else 1e-5
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref).abs().max()) <= tol * float(ref.abs().max())


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _logits(seed=0, shape=(3, 5, 64)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 2.0


@pytest.mark.parametrize("k", [0, 1, 7, 63, 64, 900])
def test_filter_top_k_matches_jax(k):
    lg = _logits(1)
    np.testing.assert_array_equal(filter_top_k(torch.from_numpy(lg), k).numpy(), np.asarray(jfilter_top_k(jnp.asarray(lg), k)))


@pytest.mark.parametrize("p", [0.0, 0.3, 0.9, 0.96, 1.0])
def test_filter_top_p_matches_jax(p):
    lg = np.array(jfilter_top_k(jnp.asarray(_logits(2)), 20))  # NEG_INF entries from a top-k pass
    np.testing.assert_array_equal(filter_top_p(torch.from_numpy(lg), p).numpy(), np.asarray(jfilter_top_p(jnp.asarray(lg), p)))


@pytest.mark.parametrize("tk,tp", [(0, 0.0), (10, 0.0), (0, 0.9), (20, 0.96)])
def test_injected_gumbel_sample_equals_jax_categorical(tk, tp):
    lg = _logits(3, (4, 9, 64))
    key = jax.random.PRNGKey(5)
    jids = np.asarray(jsample(key, jnp.asarray(lg), top_k=tk, top_p=tp))
    filtered = jfilter_top_p(jfilter_top_k(jnp.asarray(lg), tk), tp)
    gumbel = jax.random.gumbel(key, lg.shape)
    # jax.random.categorical is argmax(logits + gumbel(key, logits.shape))
    np.testing.assert_array_equal(np.asarray(jnp.argmax(filtered + gumbel, axis=-1)), jids)
    ids = sample_top_k_top_p(torch.from_numpy(lg), torch.from_numpy(np.array(gumbel)), top_k=tk, top_p=tp)
    np.testing.assert_array_equal(ids.numpy(), jids)


def test_gumbel_from_uniform_is_finite_at_the_ends():
    """The stream's Gumbel at the ends of its uniform: bits 0 give u = tiny,
    all ones u = 1 − 2⁻²³, 2³¹ gives u = 0.5; all finite, as jax's."""
    bits = torch.tensor([0, 2**31, 2**32 - 1], dtype=torch.int64)
    g = threefry.gumbel_from_bits(bits)
    assert bool(torch.isfinite(g).all())
    assert abs(float(g[1]) - (-math.log(-math.log(0.5)))) < 1e-6
    u = threefry.uniform_from_bits(bits, torch.finfo(torch.float32).tiny, 1.0)
    assert float(u[0]) == torch.finfo(torch.float32).tiny and float(u[2]) == 1.0 - 2 ** -23


