"""The port's DC-AE encoder against the JAX package's on the CPU.

- ``init_encoder`` draws the JAX tree leaf by leaf from the same key (the
  threefry stream's bound, ``INIT_ATOL``).
- ``encode`` with the JAX weights carried across agrees within 1e-4 (f32,
  float and int8 base); measured max abs error ≈ 1e-6.
- The port's own encoder from the seed agrees within 1e-4 too (nothing
  injected), and the latents have the decoder's grid.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.models import dcae as jdcae
from hyperscalees_t2i_tpu.ops.quant import quantize_tree as jquantize_tree
from hyperscalees_t2i_tpu_torch.models import dcae as tdcae
from hyperscalees_t2i_tpu_torch.ops.quant import quantize_tree
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.weights.from_jax import tree_from_numpy

from test_torch_threefry import assert_tree_matches_jax

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(latent_channels=4, channels=(16, 16, 8), blocks_per_stage=(1, 2, 1), attn_stages=())


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _images(n=2, hw=16):
    return np.random.default_rng(4).uniform(size=(n, hw, hw, 3)).astype(np.float32)


@pytest.mark.parametrize("blocks", [(1, 2, 1), (2, 1, 1)])
def test_init_encoder_matches_jax_leaf_by_leaf(blocks):
    kw = dict(KW, blocks_per_stage=blocks)
    assert_tree_matches_jax(jdcae.init_encoder(jax.random.PRNGKey(5), jdcae.DCAEConfig(**kw)),
                            tdcae.init_encoder(tdcae.DCAEConfig(**kw), threefry.prng_key(5, "cpu")))


@pytest.mark.parametrize("quant", [False, True])
def test_encode_matches_jax(quant):
    jcfg = jdcae.DCAEConfig(**KW, compute_dtype=jnp.float32)
    tcfg = tdcae.DCAEConfig(**KW, compute_dtype=torch.float32)
    params = jdcae.init_encoder(jax.random.PRNGKey(5), jcfg)
    if quant:
        params = jquantize_tree(params, min_size=0)
    img = _images()
    j = np.asarray(jdcae.encode(params, jcfg, jnp.asarray(img)))
    model = tdcae.DCAEEncoder(tcfg, tree_from_numpy(_np_tree(params), "cpu"))
    with torch.inference_mode():
        out = tdcae.encode(model, torch.from_numpy(img)).numpy()
    assert out.shape == j.shape == (2, 4, 4, 4) and out.dtype == np.float32
    np.testing.assert_allclose(out, j, **TOL)


def test_encoder_from_a_seed_matches_jax():
    """Nothing injected: the port's own weights from the key, int8 base."""
    jcfg = jdcae.DCAEConfig(**KW, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tdcae.DCAEConfig(**KW), compute_dtype=torch.float32)
    img = _images(1, 8)
    j = np.asarray(jdcae.encode(jquantize_tree(jdcae.init_encoder(jax.random.PRNGKey(9), jcfg), min_size=0),
                                jcfg, jnp.asarray(img)))
    params = quantize_tree(tdcae.init_encoder(tcfg, threefry.prng_key(9, "cpu")), min_size=0)
    with torch.inference_mode():
        out = tdcae.DCAEEncoder(tcfg, params)(torch.from_numpy(img)).numpy()
    assert out.shape == (1, 2, 2, 4)
    np.testing.assert_allclose(out, j, **TOL)
