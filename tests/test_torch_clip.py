"""Port parity: the CLIP towers, the CLIP resize and the reward suite.

``preprocess_images`` downsamples 1024→224 and 512→224 with the JAX
package's antialiased Keys-cubic weights (bound 1e-5 in f32; measured
2.2e-6). Tiny towers (f32 and int8 with every kernel quantized) carried
over from the JAX package by ``weights.from_jax.clip_from_jax``;
``image_features``, ``text_features`` and ``compute_rewards_batch`` with
and without PickScore at rtol/atol 1e-4 (measured ≤ 2.5e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.models import clip as jclip
from hyperscalees_t2i_tpu.ops.quant import quantize_tree as jquantize_tree
from hyperscalees_t2i_tpu.rewards import suite as jsuite
from hyperscalees_t2i_tpu_torch.models import clip as tclip
from hyperscalees_t2i_tpu_torch.rewards import suite as tsuite
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.weights.from_jax import clip_from_jax

from test_torch_threefry import assert_tree_matches_jax

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
TOWER = dict(image_size=32, patch_size=16, vocab_size=64, max_positions=8, projection_dim=24)


def _cfgs(act="quick_gelu"):
    jt, tt = jclip.CLIPTowerConfig(32, 2, 2, 64), tclip.CLIPTowerConfig(32, 2, 2, 64)
    return (jclip.CLIPConfig(vision=jt, text=jt, hidden_act=act, **TOWER),
            tclip.CLIPConfig(vision=tt, text=tt, hidden_act=act, **TOWER))


@pytest.mark.parametrize("size", [1024, 512])
def test_preprocess_resize_matches_jax(size):
    im = np.random.default_rng(size).random((2, size, size, 3)).astype(np.float32)
    j = jclip.preprocess_images(jnp.asarray(im), jclip.CLIP_B32)
    t = tclip.preprocess_images(torch.from_numpy(im), tclip.CLIP_B32)
    assert t.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_published_tower_geometries_match_jax():
    for j, t in ((jclip.CLIP_B32, tclip.CLIP_B32), (jclip.CLIP_H14, tclip.CLIP_H14)):
        assert dataclasses.asdict(t.vision) == dataclasses.asdict(j.vision)
        assert dataclasses.asdict(t.text) == dataclasses.asdict(j.text)
        assert (t.image_size, t.patch_size, t.projection_dim, t.hidden_act) == \
            (j.image_size, j.patch_size, j.projection_dim, j.hidden_act)


def test_init_clip_matches_jax_leaf_by_leaf():
    jcfg, tcfg = _cfgs()
    assert_tree_matches_jax(jclip.init_clip(jax.random.PRNGKey(4), jcfg), tclip.init_clip(tcfg, threefry.prng_key(4, "cpu")))


def test_random_reward_suite_draws_bench_keys():
    """``build_random_reward_suite(key)`` draws what the JAX ``bench.py``'s
    ``_init_rewards(key)`` draws: the towers and the random token ids of
    both text tables (here in f32, held against the JAX tables)."""
    from hyperscalees_t2i_tpu.rungs import PROMPT_TOKEN_LEN

    jcfg, tcfg = _cfgs()
    M = 3
    suite = tsuite.build_random_reward_suite(tcfg, tcfg, M, threefry.prng_key(1, "cpu"), torch.float32)
    kc, kp, ki = jax.random.split(jax.random.PRNGKey(1), 3)
    kc2, ki2 = jax.random.split(kc)
    ids = jax.random.randint(ki2, (M + 2, PROMPT_TOKEN_LEN), 0, jcfg.vocab_size)
    table = jsuite.clip_text_embed_table(jclip.init_clip(kc2, jcfg), jcfg, ids)
    np.testing.assert_allclose(suite.clip_text_table.numpy(), np.asarray(table), **TOL)
    pids = jax.random.randint(ki, (M, PROMPT_TOKEN_LEN), 0, jcfg.vocab_size)
    ptable = jsuite.pickscore_text_embeds(jclip.init_clip(kp, jcfg), jcfg, pids)
    np.testing.assert_allclose(suite.pick_text_embeds.numpy(), np.asarray(ptable), **TOL)


@pytest.fixture(scope="module", params=["float-quick_gelu", "int8-gelu"])
def towers(request):
    base, act = request.param.split("-")
    jcfg, tcfg = _cfgs(act)
    params = jclip.init_clip(jax.random.PRNGKey(0), jcfg)
    if base == "int8":
        params = jquantize_tree(params, min_size=0)
    return jcfg, params, clip_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")


def test_image_and_text_features_match_jax(towers):
    jcfg, params, model = towers
    r = np.random.default_rng(1)
    pix = r.normal(size=(3, 32, 32, 3)).astype(np.float32)
    ids = r.integers(0, 64, size=(3, 8)).astype(np.int32)
    mask = np.ones((3, 8), bool)
    mask[1, 6:] = False
    with torch.inference_mode():
        ti = tclip.image_features(model, torch.from_numpy(pix))
        tt = tclip.text_features(model, torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(ti.numpy(), np.asarray(jclip.image_features(params, jcfg, jnp.asarray(pix))), **TOL)
    jt = jclip.text_features(params, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)


@pytest.mark.parametrize("pick", [False, True])
def test_compute_rewards_batch_matches_jax(towers, pick):
    jcfg, params, model = towers
    r = np.random.default_rng(2)
    images = r.random((4, 64, 64, 3)).astype(np.float32)  # resized 64 → 32
    ids = r.integers(0, 64, size=(5 + 2, 8)).astype(np.int32)
    prompt_ids = np.array([0, 3, 4, 3])
    jtable = jsuite.clip_text_embed_table(params, jcfg, jnp.asarray(ids))
    with torch.inference_mode():
        ttable = tsuite.clip_text_embed_table(model, torch.from_numpy(ids).long())
    np.testing.assert_allclose(ttable.numpy(), np.asarray(jtable), **TOL)
    jkw, tkw = {}, {}
    if pick:
        pids = ids[:5]
        jkw = dict(pick_params=params, pick_cfg=jcfg,
                   pick_text_embeds=jsuite.pickscore_text_embeds(params, jcfg, jnp.asarray(pids)))
        with torch.inference_mode():
            tkw = dict(pick_model=model,
                       pick_text_embeds=tsuite.pickscore_text_embeds(model, torch.from_numpy(pids).long()))
    j = jsuite.compute_rewards_batch(params, jcfg, jnp.asarray(images), jtable, jnp.asarray(prompt_ids), **jkw)
    with torch.inference_mode():
        t = tsuite.make_clip_reward_fn(model, ttable, **tkw)(torch.from_numpy(images), torch.from_numpy(prompt_ids))
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), **TOL)
    assert (t["pickscore"].numpy() != 0).all() == pick
