"""Port parity: the Z-Image family's modules at a tiny size, f32.

The JAX package's ``models/zimage.py`` and ``models/vaekl.py`` (d 24, 2
layers, 2 heads, caption 12; the decoder at ch (8, 8)) against the port's
on the same weights and inputs, made from seeds:

- ``init_zimage``/``init_decoder`` from a seed, leaf by leaf within 1e-6;
- the axial RoPE tables within 1e-4 (measured 6.0e-8, also at
  Z-Image-Turbo's 1,048 × 64 table), ``shifted_times`` (XLA's f32
  ``linspace``) bitwise, the ×1000 timestep features within 1e-4 (measured
  2.6e-5: angles up to 1,000 rad);
- ``forward`` with ragged text whose padded rows hold garbage, on a float
  and an int8 base, with an adapter, within 1e-4 (measured 4.8e-7 on
  both); the padded rows change nothing, bitwise;
- ``decode`` with conv LoRA, raw and with a factored ``b`` (one member and
  a laned chunk), on a float and an int8 base, within 1e-4 (measured 9.3e-7
  raw, 3.1e-6 factored); the laned grouped conv equals each lane alone
  within 1e-6 of the largest output (measured 3.1e-5 on outputs up to ≈ 60);
- ``generate_latents`` within 3e-4 (measured 3.6e-7, 9.6e-7 with guidance
  1.5); ``generate_p`` is the same however its images are chunked, bitwise,
  and a lane of a two-lane chunk is the lane alone within 1e-6 (measured
  3.6e-7: the CPU matmul rounds by row count);
- ``quantize_tree`` routes the same nodes of both trees (``ada_lin`` stacked,
  the 3×3 and 1×1 convs) with the same int8 values and scales, bitwise;
- the dual θ (``init_theta``), its ES noise and each member's factored and
  materialized adapter (conv ``a`` factors dense-noised) within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.backends.zimage_backend import ZImageBackend as JBackend
from hyperscalees_t2i_tpu.backends.zimage_backend import ZImageBackendConfig as JConfig
from hyperscalees_t2i_tpu.es import noiser as jnoiser
from hyperscalees_t2i_tpu.lora import FactoredDelta as JFactoredDelta
from hyperscalees_t2i_tpu.lora import init_lora as jinit_lora
from hyperscalees_t2i_tpu.models import nn as jnn
from hyperscalees_t2i_tpu.models import vaekl as jv
from hyperscalees_t2i_tpu.models import zimage as jz
from hyperscalees_t2i_tpu.ops import quant as jquant
from hyperscalees_t2i_tpu_torch.backends.zimage_backend import ZImageBackend, ZImageBackendConfig
from hyperscalees_t2i_tpu_torch.es import noiser
from hyperscalees_t2i_tpu_torch.lora import FactoredDelta, stack_adapters
from hyperscalees_t2i_tpu_torch.models import nn as tnn_
from hyperscalees_t2i_tpu_torch.models import sana as tsana
from hyperscalees_t2i_tpu_torch.models import vaekl as tv
from hyperscalees_t2i_tpu_torch.models import zimage as tz
from hyperscalees_t2i_tpu_torch.ops import quant as tquant
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.utils.pytree import tree_leaves, tree_leaves_with_path, tree_map
from hyperscalees_t2i_tpu_torch.weights.from_jax import tree_from_numpy

from test_torch_threefry import assert_tree_matches_jax


def assert_leaves_match_jax(jtree, ttree, atol):
    """Leaf by leaf in flattening order (named-tuple nodes included): the
    same shapes, values within ``atol``. Returns the largest difference."""
    jl = [np.asarray(v) for v in jax.tree_util.tree_leaves(jtree)]
    tl = [v.detach().numpy() for v in tree_leaves(ttree)]
    assert len(jl) == len(tl)
    worst = 0.0
    for j, t in zip(jl, tl):
        assert j.shape == t.shape, (j.shape, t.shape)
        err = float(np.abs(j.astype(np.float64) - t.astype(np.float64)).max()) if j.size else 0.0
        assert err <= atol, err
        worst = max(worst, err)
    return worst

torch.set_num_threads(1)
MOD_TOL = dict(rtol=1e-4, atol=1e-4)
PATH_TOL = dict(rtol=3e-4, atol=3e-4)
TINY = dict(in_channels=4, patch_size=2, d_model=24, n_layers=2, n_heads=2, caption_dim=12, ff_ratio=2.0, num_steps=2)
VTINY = dict(latent_channels=4, ch=(8, 8), blocks_per_stage=1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jcfg(**kw):
    return jz.ZImageConfig(**{**TINY, **kw}, compute_dtype=jnp.float32)


def tcfg(**kw):
    return tz.ZImageConfig(**{**TINY, **kw}, compute_dtype=torch.float32)


def jvcfg():
    return jv.VAEDecoderConfig(**VTINY, compute_dtype=jnp.float32)


def tvcfg():
    return tv.VAEDecoderConfig(**VTINY, compute_dtype=torch.float32)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _perturbed(tree, seed, scale=0.1):
    """A JAX tree with every leaf moved by seeded noise (identity adapters
    become non-trivial ones)."""
    leaves, tdef = jax.tree_util.tree_flatten(tree)
    return jax.tree_util.tree_unflatten(tdef, [l + _rand(seed + i, *l.shape, scale=scale) for i, l in enumerate(leaves)])


def test_init_from_a_seed_matches_jax():
    jp = jz.init_zimage(jax.random.PRNGKey(3), jcfg())
    tp = tz.init_zimage(tcfg(), threefry.prng_key(3, "cpu"))
    assert assert_tree_matches_jax(jp, tp, atol=1e-6) <= 1e-6
    jvp = jv.init_decoder(jax.random.PRNGKey(4), jvcfg())
    tvp = tv.init_decoder(tvcfg(), threefry.prng_key(4, "cpu"))
    assert assert_tree_matches_jax(jvp, tvp, atol=1e-6) <= 1e-6
    # node_fn sees every dense node once, as it is drawn
    seen = []
    tz.init_zimage(tcfg(), threefry.prng_key(3, "cpu"), node_fn=lambda n: seen.append(tuple(n["kernel"].shape)) or n)
    assert len(seen) == 11 and (2, 24, 144) in seen


@pytest.mark.parametrize("geom", [(6, 2, 2, 12), (5, 3, 4, 24), (24, 32, 32, 128)])
def test_rope_tables_match_jax(geom):
    Lt, gh, gw, dh = geom
    jc, js = jz._axial_rope(Lt, gh, gw, dh, 10000.0)
    tc, ts = tz.axial_rope(Lt, gh, gw, dh, 10000.0)
    assert tuple(tc.shape) == (Lt + gh * gw, dh // 2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **MOD_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **MOD_TOL)


@pytest.mark.parametrize("steps,shift", [(1, 3.0), (2, 3.0), (8, 3.0), (8, 1.0), (30, 5.0)])
def test_shifted_times_match_jax_bitwise(steps, shift):
    want = np.asarray(jz.shifted_times(jcfg(num_steps=steps, shift=shift)), np.float32)
    got = np.asarray(tz.shifted_times(tcfg(num_steps=steps, shift=shift)), np.float32)
    np.testing.assert_array_equal(got, want)


def test_timestep_features_match_jax():
    t = np.array([1.0, 0.75, 0.31, 0.0], np.float32)
    want = np.asarray(jnn.timestep_embedding(jnp.asarray(t), 256, scale=1000.0))
    got = tnn_.timestep_embedding(torch.from_numpy(t), 256, scale=1000.0).numpy()
    np.testing.assert_allclose(got, want, **MOD_TOL)


def _forward_inputs():
    B, Lt = 2, 6
    lat = _rand(1, B, 4, 4, 4)
    emb = _rand(2, B, Lt, 12)
    mask = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 0]], bool)
    garbage = np.where(mask[..., None], emb, 999.0).astype(np.float32)
    return lat, np.array([0.7, 0.3], np.float32), emb, garbage, mask


@pytest.mark.parametrize("base", ["float", "int8"])
def test_forward_matches_jax_and_ignores_padded_text(base):
    jp = jz.init_zimage(jax.random.PRNGKey(0), jcfg())
    if base == "int8":
        jp = jquant.quantize_tree(jp, min_size=1)
    lora = _perturbed(jinit_lora(jax.random.PRNGKey(5), jp, jcfg().lora_spec(2, 4.0)), 10)
    lat, t, emb, garbage, mask = _forward_inputs()
    want = np.asarray(jz.forward(jp, jcfg(), lat, t, emb, mask, lora=lora, lora_scale=2.0))
    model = tz.ZImageTransformer(tcfg(), tree_from_numpy(_np(jp), "cpu"))
    assert any(hasattr(m, "q8") for m in model.blocks.modules()) == (base == "int8")
    tl = tree_from_numpy(_np(lora), "cpu")
    run = lambda e: model(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(e),  # noqa: E731
                          torch.from_numpy(mask), tl, 2.0)
    got = run(emb)
    np.testing.assert_allclose(got.numpy(), want, **MOD_TOL)
    assert torch.equal(run(garbage), got)


def _decode_theta(jvp):
    return _perturbed(jinit_lora(jax.random.PRNGKey(1), jvp, jvcfg().lora_spec(2, 4.0)), 20, scale=0.2)


@pytest.mark.parametrize("base", ["float", "int8"])
@pytest.mark.parametrize("form", ["raw", "factored", "laned"])
def test_decode_with_conv_lora_matches_jax(base, form):
    jvp = jv.init_decoder(jax.random.PRNGKey(0), jvcfg())
    if base == "int8":
        jvp = jquant.quantize_tree(jvp, min_size=64)
    th = _decode_theta(jvp)
    z = _rand(2, 2, 4, 4, 4, scale=0.3)
    dec = tv.KLDecoder(tvcfg(), tree_from_numpy(_np(jvp), "cpu"))
    assert any(hasattr(m, "q8_oihw") for m in dec.modules()) == (base == "int8")
    if form == "raw":
        want = np.asarray(jv.decode(jvp, jvcfg(), z, lora=th, lora_scale=2.0))
        got = tv.decode(dec, torch.from_numpy(z), tree_from_numpy(_np(th), "cpu"), 2.0)
    else:
        # the fused member path: b factored (u, v, c), a materialized; laned:
        # two members, each its own a and factored b, over two image rows each
        lanes = 2 if form == "laned" else 1
        rng = np.random.default_rng(7)
        per = []
        for k in range(lanes):
            leaf = {}
            for path, f in th.items():
                r, cout = f["b"].shape
                u = rng.standard_normal((r, 2)).astype(np.float32)
                v = rng.standard_normal((cout, 2)).astype(np.float32)
                leaf[path] = {"a": np.asarray(f["a"]) + 0.05 * k,
                              "b": JFactoredDelta(np.asarray(f["b"]), u, v, np.float32(0.3 + 0.1 * k))}
            per.append(leaf)
        zz = np.concatenate([z] * lanes)
        want = np.concatenate([np.asarray(jv.decode(jvp, jvcfg(), z, lora=per[k], lora_scale=2.0))
                               for k in range(lanes)])
        tl = [tree_from_numpy(p, "cpu") for p in per]
        if lanes == 1:
            lora = tl[0]
        else:
            lora = {p: {"a": torch.stack([t[p]["a"] for t in tl]),
                        "b": FactoredDelta(tl[0][p]["b"].w, torch.stack([t[p]["b"].u for t in tl]),
                                           torch.stack([t[p]["b"].v for t in tl]),
                                           torch.stack([t[p]["b"].c for t in tl]))} for p in tl[0]}
        got = tv.decode(dec, torch.from_numpy(zz), lora, 2.0)
    np.testing.assert_allclose(got.numpy(), want, **MOD_TOL)


def test_laned_conv_lora_equals_each_lane():
    x = torch.from_numpy(_rand(3, 6, 5, 7, 8))
    a = torch.from_numpy(_rand(4, 3, 3, 3, 8, 4))
    b = torch.from_numpy(_rand(5, 3, 4, 6))
    laned = tnn_.conv_lora_delta(x, {"a": a, "b": b}, 2.0)
    each = torch.cat([tnn_.conv_lora_delta(x[2 * i:2 * i + 2], {"a": a[i], "b": b[i]}, 2.0) for i in range(3)])
    # a grouped conv sums in another order: within 1e-6 of the largest output
    np.testing.assert_allclose(laned.numpy(), each.numpy(), rtol=0, atol=1e-6 * float(each.abs().max()))


@pytest.mark.parametrize("guidance", [0.0, 1.5])
def test_generate_latents_matches_jax(guidance):
    jp = jz.init_zimage(jax.random.PRNGKey(0), jcfg())
    lora = _perturbed(jinit_lora(jax.random.PRNGKey(5), jp, jcfg().lora_spec(2, 4.0)), 30)
    _, _, emb, _, mask = _forward_inputs()
    key = jax.random.PRNGKey(9)
    idx = np.array([3, 7])
    want = np.asarray(jz.generate_latents(jp, jcfg(), emb, mask, key, item_index=jnp.asarray(idx), latent_hw=(4, 4),
                                          guidance_scale=guidance, lora=lora, lora_scale=2.0))
    model = tz.ZImageTransformer(tcfg(), tree_from_numpy(_np(jp), "cpu"))
    noise = tsana.per_image_normal(threefry.prng_key(9, "cpu"), idx, (4, 4, 4))
    got = tz.generate_latents(model, torch.from_numpy(emb), torch.from_numpy(mask), noise, guidance_scale=guidance,
                              lora=tree_from_numpy(_np(lora), "cpu"), lora_scale=2.0)
    np.testing.assert_allclose(got.numpy(), want, **PATH_TOL)


def _tiny_backend(tmp_path, **kw):
    prompts = tmp_path / "p.txt"
    prompts.write_text("a red square\na blue circle\na cat\n")
    cfg = ZImageBackendConfig(model=tcfg(), vae=tvcfg(), prompts_txt_path=str(prompts), num_steps=2, width_latent=4,
                              height_latent=4, lora_r=2, lora_alpha=4.0, **kw)
    b = ZImageBackend(cfg, "cpu")
    b.setup()
    return b


def test_generate_p_is_chunk_invariant_bitwise(tmp_path):
    b = _tiny_backend(tmp_path, train_vae_decoder_lora=True)
    theta = tree_map(lambda t: t + 0.1, b.init_theta(threefry.prng_key(0, "cpu")))
    key = threefry.prng_key(4, "cpu")
    ids = torch.tensor([[0, 1, 2, 1]])
    noise = b.sample_gen_noise(key, range(4))
    stacked = tree_map(lambda t: t[None], theta)
    whole = b.generate_p(stacked, ids, key[None])
    parts = torch.cat([b.generate_p(stacked, ids[:, i:i + 2], None, noise=noise[i:i + 2][None])
                       for i in (0, 2)], dim=1)
    assert torch.equal(whole, parts)
    # the draw itself: the same rows at their global positions
    assert torch.equal(b.sample_gen_noise(key, [2, 3]), noise[2:])
    # two lanes with their own adapters: each lane as it is alone, up to the
    # CPU matmul's rounding at another row count
    other = tree_map(lambda t: t * 0.5, theta)
    both = b.generate_p(stack_adapters([theta, other]), ids.expand(2, -1), None, noise=noise.expand(2, *noise.shape))
    alone = b.generate_p(tree_map(lambda t: t[None], other), ids, None, noise=noise[None])[0]
    np.testing.assert_allclose(both[1].numpy(), alone.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("min_size", [512, tquant.DEFAULT_MIN_SIZE])
def test_quantize_routing_matches_jax_bitwise(min_size):
    jp = jz.init_zimage(jax.random.PRNGKey(0), jcfg(d_model=64, n_heads=4, caption_dim=64))
    jvp = jv.init_decoder(jax.random.PRNGKey(1), jv.VAEDecoderConfig(latent_channels=4, ch=(64, 32),
                                                                         blocks_per_stage=1))
    for tree in (jp, jvp):
        jq = jquant.quantize_tree(tree, min_size=min_size)
        tq = tquant.maybe_quantize_tree(tree_from_numpy(_np(tree), "cpu"), "int8", min_size)
        jl = [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p), np.asarray(v))
              for p, v in jax.tree_util.tree_flatten_with_path(jq)[0]]
        tl = list(tree_leaves_with_path(tq))
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (p, j), (_, t) in zip(jl, tl):
            np.testing.assert_array_equal(t.numpy(), j, err_msg=p)
    jq = jquant.quantize_tree(jp, min_size=512)
    assert {"ada_lin", "qkv", "attn_proj", "fc1", "fc2"} <= {k for k, v in jq["blocks"].items()
                                                            if isinstance(v, dict) and "kernel_q8" in v}


def _jax_backend(tmp_path):
    prompts = tmp_path / "p.txt"
    prompts.write_text("a red square\na blue circle\na cat\n")
    jb = JBackend(JConfig(model=jcfg(), vae=jvcfg(), prompts_txt_path=str(prompts), num_steps=2, width_latent=4,
                          height_latent=4, lora_r=2, lora_alpha=4.0, train_vae_decoder_lora=True))
    jb.setup()
    return jb


def test_dual_theta_and_member_draws_match_jax(tmp_path):
    jb = _jax_backend(tmp_path)
    b = _tiny_backend(tmp_path, train_vae_decoder_lora=True)
    # the same synthetic prompts (24 positions, ragged masks)
    np.testing.assert_allclose(b.prompt_embeds.numpy(), np.asarray(jb.prompt_embeds), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(b.prompt_mask.numpy(), np.asarray(jb.prompt_mask))
    jtheta = jb.init_theta(jax.random.PRNGKey(11))
    theta = b.init_theta(threefry.prng_key(11, "cpu"))
    assert set(theta) == {"transformer", "vae_decoder"}
    assert assert_tree_matches_jax(jtheta, theta, atol=1e-6) <= 1e-6
    jtheta = _perturbed(jtheta, 40)
    theta = tree_from_numpy(_np(jtheta), "cpu")
    es = jnoiser.EggRollConfig(sigma=0.05, rank=2)
    tes = noiser.EggRollConfig(sigma=0.05, rank=2)
    jn = jnoiser.sample_noise(jax.random.PRNGKey(12), jtheta, 4, es)
    tn = noiser.sample_noise(threefry.prng_key(12, "cpu"), theta, 4, tes)
    assert assert_leaves_match_jax(jn, tn, atol=1e-6) <= 1e-6
    tn = tree_from_numpy(_np(jn), "cpu")
    for k in range(4):
        want = jnoiser.factored_member_theta(jtheta, jn, jnp.int32(k), 4, es)
        got = noiser.factored_member_theta(theta, tn, k, 4, tes)
        assert assert_leaves_match_jax(want, got, atol=1e-6) <= 1e-6
        want = jnoiser.perturb_member(jtheta, jn, jnp.int32(k), 4, es)
        got = noiser.perturb_member(theta, tn, k, 4, tes)
        assert assert_leaves_match_jax(want, got, atol=1e-6) <= 1e-6
    # a laned chunk: conv a factors dense-noised per lane
    got = noiser.factored_member_theta(theta, tn, [1, 2], 4, tes)
    a = got["vae_decoder"]["conv_out"]["a"]
    assert tuple(a.shape) == (2, *theta["vae_decoder"]["conv_out"]["a"].shape)
    assert isinstance(got["vae_decoder"]["conv_out"]["b"], FactoredDelta)
