"""Port parity: the Sana DiT, the one-step sampler and the DC-AE decoder.

The tiny f32 config of tests/test_golden.py, with an int8 base
(``quantize_tree(min_size=0)``: every kernel, the depthwise and patch convs
included) and a non-zero adapter. JAX-initialized weights are carried over
by ``weights/from_jax.py``; the sampler noise is the JAX package's
``sana._per_image_normal``, injected, and, with nothing injected, the
port's own draw from the same key. Bound 3e-4 (the golden bound);
measured max abs error 1.4e-6 (DiT) and 6e-7 (decoder). The port's random
inits equal the JAX inits from the same key within 1e-6, leaf by leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.lora import init_lora as jinit_lora
from hyperscalees_t2i_tpu.models import dcae as jdcae
from hyperscalees_t2i_tpu.models import sana as jsana
from hyperscalees_t2i_tpu.ops.quant import quantize_tree as jquantize_tree
from hyperscalees_t2i_tpu_torch.lora import LoRASpec as TLoRASpec
from hyperscalees_t2i_tpu_torch.lora import init_lora as tinit_lora
from hyperscalees_t2i_tpu_torch.models import dcae as tdcae
from hyperscalees_t2i_tpu_torch.models import sana as tsana
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.weights.from_jax import adapter_from_jax, dcae_from_jax, sana_from_jax, tree_from_numpy

from test_torch_threefry import assert_tree_matches_jax

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
SANA_KW = dict(in_channels=4, out_channels=4, d_model=32, n_layers=2, n_heads=4,
               cross_n_heads=4, caption_dim=16, ff_ratio=2.0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module", params=["float", "int8"])
def sana_pair(request):
    jcfg = jsana.SanaConfig(**SANA_KW, compute_dtype=jnp.float32)
    tcfg = tsana.SanaConfig(**SANA_KW, compute_dtype=torch.float32)
    params = jsana.init_sana(jax.random.PRNGKey(11), jcfg)
    if request.param == "int8":
        params = jquantize_tree(params, min_size=0)
    spec = jcfg.lora_spec()
    lora = jinit_lora(jax.random.PRNGKey(7), params, spec)
    lora = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(8), x.shape), lora
    )
    model = sana_from_jax(_np_tree(params), tcfg, "cpu")
    return dict(jcfg=jcfg, params=params, lora=lora, spec=spec, model=model,
                tlora=adapter_from_jax(_np_tree(lora), "cpu"))


def test_sana_forward_matches_jax(sana_pair):
    s = sana_pair
    r = np.random.default_rng(0)
    lat = r.normal(size=(2, 4, 4, 4)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    cap = r.normal(size=(2, 6, 16)).astype(np.float32)
    mask = np.array([[1] * 6, [1, 1, 1, 1, 0, 0]], bool)
    g = np.array([0.1, 0.45], np.float32)
    j = jsana.sana_forward(s["params"], s["jcfg"], jnp.asarray(lat), jnp.asarray(t), jnp.asarray(cap),
                           jnp.asarray(mask), jnp.asarray(g), s["lora"], s["spec"].scale)
    with torch.inference_mode():
        out = tsana.sana_forward(s["model"], torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(cap),
                                 torch.from_numpy(mask), torch.from_numpy(g), s["tlora"], s["spec"].scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), **TOL)


def test_one_step_generate_matches_jax(sana_pair):
    s = sana_pair
    emb = jax.random.normal(jax.random.PRNGKey(12), (2, 6, 16))
    key = jax.random.PRNGKey(13)
    j = jsana.one_step_generate(s["params"], s["jcfg"], emb, jnp.ones((2, 6), bool), key,
                                latent_hw=(4, 4), lora=s["lora"], lora_scale=s["spec"].scale)
    noise = np.array(jsana._per_image_normal(key, None, 2, (4, 4, 4)))
    with torch.inference_mode():
        out = tsana.one_step_generate(s["model"], torch.from_numpy(np.array(emb)), torch.ones(2, 6, dtype=torch.bool),
                                      latent_hw=(4, 4), lora=s["tlora"], lora_scale=s["spec"].scale,
                                      noise=torch.from_numpy(noise))
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(j), **TOL)


def test_init_lora_has_the_jax_tree_structure(sana_pair):
    """Same paths, factor shapes and values as the JAX package's
    ``init_lora`` from the same key (one key per kernel path, targeted or
    not), including the time-embedder adapters the forward never reads."""
    s = sana_pair
    shapes = tree_from_numpy(_np_tree(s["params"]), "cpu")
    t = tinit_lora(shapes, TLoRASpec(rank=8, alpha=16.0, targets=jsana.SANA_LORA_TARGETS), threefry.prng_key(7, "cpu"))
    assert sorted(t) == sorted(s["lora"])
    for k, leaf in s["lora"].items():
        assert tuple(t[k]["a"].shape) == leaf["a"].shape and tuple(t[k]["b"].shape) == leaf["b"].shape
        assert float(t[k]["b"].abs().max()) == 0.0
    assert_tree_matches_jax(jinit_lora(jax.random.PRNGKey(7), s["params"], s["spec"]), t)


def test_per_image_noise_depends_only_on_seed_and_index():
    key = threefry.prng_key(5, "cpu")
    a = tsana.per_image_normal(key, [0, 1, 2], (2, 2, 3))
    b = tsana.per_image_normal(key, [2], (2, 2, 3))
    assert torch.equal(a[2], b[0]) and not torch.equal(a[0], a[1])
    j = np.asarray(jsana._per_image_normal(jax.random.PRNGKey(5), jnp.arange(3), 3, (2, 2, 3)))
    np.testing.assert_allclose(a.numpy(), j, rtol=0, atol=1e-6)


def test_init_sana_matches_jax_leaf_by_leaf():
    for kw in (SANA_KW, dict(SANA_KW, guidance_embeds=True)):
        jcfg = jsana.SanaConfig(**kw, compute_dtype=jnp.float32)
        tcfg = tsana.SanaConfig(**kw, compute_dtype=torch.float32)
        assert_tree_matches_jax(jsana.init_sana(jax.random.PRNGKey(11), jcfg), tsana.init_sana(tcfg, threefry.prng_key(11, "cpu")))


@pytest.mark.parametrize("attn_stages", [(), (0,)])
def test_init_decoder_matches_jax_leaf_by_leaf(attn_stages):
    kw = dict(latent_channels=4, channels=(16, 16, 8), blocks_per_stage=(1, 2, 1), attn_stages=attn_stages)
    assert_tree_matches_jax(jdcae.init_decoder(jax.random.PRNGKey(3), jdcae.DCAEConfig(**kw)),
                            tdcae.init_decoder(tdcae.DCAEConfig(**kw), threefry.prng_key(3, "cpu")))


def test_one_step_generate_from_a_key_matches_jax(sana_pair):
    """Nothing injected: the port draws its latents from the same key."""
    s = sana_pair
    emb = jax.random.normal(jax.random.PRNGKey(12), (3, 6, 16))
    key = jax.random.PRNGKey(13)
    idx = jnp.array([4, 0, 9])
    j = jsana.one_step_generate(s["params"], s["jcfg"], emb, jnp.ones((3, 6), bool), key,
                                latent_hw=(4, 4), lora=s["lora"], lora_scale=s["spec"].scale, item_index=idx)
    with torch.inference_mode():
        out = tsana.one_step_generate(s["model"], torch.from_numpy(np.array(emb)), torch.ones(3, 6, dtype=torch.bool),
                                      threefry.prng_key(13, "cpu"), latent_hw=(4, 4), lora=s["tlora"],
                                      lora_scale=s["spec"].scale, item_index=[4, 0, 9])
    np.testing.assert_allclose(out.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_dcae_decode_matches_jax(quant):
    kw = dict(latent_channels=4, channels=(16, 16, 8), blocks_per_stage=(1, 1, 1), attn_stages=(0,), attn_heads=4)
    jcfg = jdcae.DCAEConfig(**kw, compute_dtype=jnp.float32)
    tcfg = tdcae.DCAEConfig(**kw, compute_dtype=torch.float32)
    params = jdcae.init_decoder(jax.random.PRNGKey(3), jcfg)
    if quant:
        params = jquantize_tree(params, min_size=0)
    lat = np.random.default_rng(1).normal(size=(2, 4, 4, 4)).astype(np.float32)
    j = jdcae.decode(params, jcfg, jnp.asarray(lat))
    with torch.inference_mode():
        out = tdcae.decode(dcae_from_jax(_np_tree(params), tcfg, "cpu"), torch.from_numpy(lat))
    assert out.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), **TOL)


def test_flagship_geometry_counts_225_int8_sites_per_image():
    """At the flagship geometry with an int8 base, every dense site and every
    1×1/patch conv of the DiT and of the decoder's attention stages routes to
    the int8 kernel: 209 DiT + 16 decoder call sites per image (shapes only,
    on the meta device)."""
    from hyperscalees_t2i_tpu_torch.ops.quant import maybe_quantize_tree
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    cfg = tsana.SanaConfig()
    meta = tree_map(lambda t: torch.empty(t.shape, device="meta"),
                    jax.eval_shape(lambda: jsana.init_sana(jax.random.PRNGKey(0), jsana.SanaConfig())))
    q = maybe_quantize_tree(meta, "int8")
    model = tsana.SanaTransformer(cfg, q)
    dense = [m for m in model.modules() if hasattr(m, "q8") and m.q8.ndim == 2]
    convs = [m for m in model.modules() if hasattr(m, "q8") and m.q8.ndim == 4]
    # per-layer: 8 attention projections + 2 FFN 1x1 convs; plus 5 time/guidance,
    # 2 caption, proj_out and patch_embed
    assert len(dense) + len(convs) == 20 * 10 + 5 + 2 + 2
    vmeta = tree_map(lambda t: torch.empty(t.shape, device="meta"),
                     jax.eval_shape(lambda: jdcae.init_decoder(jax.random.PRNGKey(0), jdcae.DCAEConfig())))
    dec = tdcae.DCAEDecoder(dataclasses.replace(tdcae.DCAEConfig()), maybe_quantize_tree(vmeta, "int8"))
    routed = [m for m in dec.modules() if hasattr(m, "q8")]
    assert len(routed) == 2 * 2 * 4
