"""Port parity: the multi-scale VQ pyramid and the CompVis decoder.

- Resizes against ``jax.image.resize`` at the canonical ``patch_nums``:
  antialiased bicubic up to the 16×16 grid from every scale, area down to
  every scale (average pool at integer ratios, the antialiased triangle
  kernel at 16→13, 16→10, …). Bound rtol/atol 1e-5; measured ≤ 4.8e-7.
- ``phi_index`` equal for the canonical geometry (K 4, S 10) and others.
- ``accumulate_scale`` (every scale), ``encode_to_scales`` and the decoder
  against the JAX package's, tiny and f32, with and without the mid
  attention. Bound rtol/atol 1e-4; measured ≤ 7.2e-7.
- ``weights.from_jax.tree_from_numpy`` carries the ``None`` leaf of a JAX
  MSVQ tree built with ``using_mid_sa=False``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.models import msvq as jmsvq
from hyperscalees_t2i_tpu_torch.models import msvq
from hyperscalees_t2i_tpu_torch.models.resize import resize_weights
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.weights.from_jax import msvq_from_jax, tree_from_numpy

from test_torch_threefry import assert_tree_matches_jax

torch.set_num_threads(1)
PATCH_NUMS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
TOL_RESIZE = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("pn", PATCH_NUMS)
def test_cubic_up_matches_jax(pn):
    x = _rand(pn, (2, pn, pn, 4))
    got = msvq.up_bicubic(torch.from_numpy(x), 16).numpy()
    np.testing.assert_allclose(got, np.asarray(jmsvq._up_bicubic(jnp.asarray(x), 16)), **TOL_RESIZE)


@pytest.mark.parametrize("pn", PATCH_NUMS)
def test_area_down_matches_jax(pn):
    x = _rand(100 + pn, (2, 16, 16, 4))
    got = msvq.down_area(torch.from_numpy(x), pn).numpy()
    assert got.shape == (2, pn, pn, 4)
    np.testing.assert_allclose(got, np.asarray(jmsvq._down_area(jnp.asarray(x), pn)), **TOL_RESIZE)


def test_resize_weights_renormalize_at_the_edges():
    """Every output's weights sum to 1 (JAX renormalizes the taps that fall
    inside the image; ``F.interpolate`` would clamp)."""
    for method in ("cubic", "linear"):
        for n_in, n_out in ((4, 16), (16, 13), (16, 10), (16, 3)):
            w = resize_weights(n_in, n_out, method)
            np.testing.assert_allclose(w.sum(0).numpy(), np.ones(n_out), rtol=1e-6, atol=1e-6)


def test_resize_weights_are_built_once_per_size_method_and_dtype():
    """The scale loop reuses one matrix per (sizes, method, device, dtype):
    the same tensor object comes back, cast once."""
    a = resize_weights(16, 13, "linear", torch.device("cpu"), torch.float32)
    assert resize_weights(16, 13, "linear", torch.device("cpu"), torch.float32) is a
    b = resize_weights(16, 13, "linear", torch.device("cpu"), torch.bfloat16)
    assert b is not a and b.dtype == torch.bfloat16 and torch.equal(b, a.to(torch.bfloat16))
    assert resize_weights(16, 13, "cubic", torch.device("cpu"), torch.float32) is not a


@pytest.mark.parametrize("S,K", [(10, 4), (3, 2), (10, 1), (6, 3), (1, 4)])
def test_phi_index_matches_jax(S, K):
    pn = tuple(range(1, S + 1))
    t, j = msvq.MSVQConfig(patch_nums=pn, phi_partial=K), jmsvq.MSVQConfig(patch_nums=pn, phi_partial=K)
    assert [msvq.phi_index(t, si) for si in range(S)] == [jmsvq.phi_index(j, si) for si in range(S)]


def test_phi_index_canonical_ticks():
    """The nearest-tick rule with its float ties, not a rounded ramp
    (``round(si/9·3)`` would give conv 2 at si = 7)."""
    cfg = msvq.MSVQConfig()
    assert [msvq.phi_index(cfg, si) for si in range(10)] == [0, 0, 1, 1, 1, 2, 2, 3, 3, 3]


def _cfgs(mid_sa: bool):
    kw = dict(vocab_size=32, c_vae=4, patch_nums=(1, 2, 3, 4), phi_partial=2, ch=8, ch_mult=(1, 2),
              num_res_blocks=1, using_sa=True, using_mid_sa=mid_sa)
    return jmsvq.MSVQConfig(**kw, compute_dtype=jnp.float32), msvq.MSVQConfig(**kw, compute_dtype=torch.float32)


@pytest.fixture(scope="module", params=[True, False], ids=["mid_sa", "no_mid_sa"])
def vq(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jmsvq.init_msvq(jax.random.PRNGKey(3), jcfg)
    # non-zero biases and norm affines, so every parameter is exercised
    jparams = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(a.size), a.shape) if a.ndim == 1 else a, jparams)
    return jcfg, jparams, tcfg, msvq_from_jax(_np(jparams), tcfg, "cpu")


def test_accumulate_scale_matches_jax(vq):
    jcfg, jparams, tcfg, tvq = vq
    r = np.random.default_rng(4)
    f_hat = r.normal(size=(2, 4, 4, 4)).astype(np.float32)
    jf, tf = jnp.asarray(f_hat), torch.from_numpy(f_hat)
    for si, pn in enumerate(jcfg.patch_nums):
        ids = r.integers(0, jcfg.vocab_size, size=(2, pn * pn))
        jf, jn = jmsvq.accumulate_scale(jparams, jcfg, jf, jnp.asarray(ids), si)
        tf, tn = msvq.accumulate_scale(tvq, tf, torch.from_numpy(ids), si)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)


def test_encode_to_scales_matches_jax_and_replays(vq):
    jcfg, jparams, tcfg, tvq = vq
    f = _rand(5, (2, 4, 4, 4))
    jids, jf = jmsvq.encode_to_scales(jparams, jcfg, jnp.asarray(f))
    tids, tf = msvq.encode_to_scales(tvq, torch.from_numpy(f))
    for a, b in zip(tids, jids):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)
    replay = torch.zeros_like(tf)
    for si, ids in enumerate(tids):
        replay, _ = msvq.accumulate_scale(tvq, replay, ids, si)
    np.testing.assert_allclose(replay.numpy(), tf.numpy(), rtol=1e-5, atol=1e-5)


def test_decoder_matches_jax(vq):
    jcfg, jparams, tcfg, tvq = vq
    f_hat = _rand(6, (2, 4, 4, 4))
    j = np.asarray(jmsvq.decode_img(jparams, jcfg, jnp.asarray(f_hat)))
    t = msvq.decode_img(tvq, torch.from_numpy(f_hat)).numpy()
    assert t.shape == (2, 8, 8, 3) and t.dtype == np.float32
    np.testing.assert_allclose(t, j, **TOL)
    assert (tvq.decoder.mid_attn_1 is None) == (not tcfg.using_mid_sa)


def test_tree_from_numpy_carries_none_leaves():
    jcfg, _ = _cfgs(False)
    tree = _np(jmsvq.init_msvq(jax.random.PRNGKey(0), jcfg))
    assert tree["decoder"]["mid"]["attn_1"] is None
    t = tree_from_numpy(tree, "cpu")
    assert t["decoder"]["mid"]["attn_1"] is None
    assert isinstance(t["decoder"]["up"], list) and torch.is_tensor(t["codebook"])
    np.testing.assert_array_equal(t["codebook"].numpy(), tree["codebook"])


def test_init_msvq_builds_the_jax_tree_structure():
    for mid in (True, False):
        jcfg, tcfg = _cfgs(mid)
        jtree = jax.tree_util.tree_structure(jmsvq.init_msvq(jax.random.PRNGKey(0), jcfg))
        ttree = msvq.init_msvq(tcfg, threefry.prng_key(0, "cpu"))
        assert_tree_matches_jax(jmsvq.init_msvq(jax.random.PRNGKey(0), jcfg), ttree)
        shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jmsvq.init_msvq(jax.random.PRNGKey(0), jcfg))
        tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ttree)
        assert jax.tree_util.tree_structure(ttree) == jtree
        assert shapes == tshapes
        assert dataclasses.asdict(tcfg).keys() == dataclasses.asdict(jcfg).keys()
