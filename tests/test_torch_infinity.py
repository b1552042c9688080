"""Port parity: the Infinity family at the tiny geometry, f32.

The JAX package's tiny Infinity (``train/cli.py --model_scale tiny``: depth
2, d 16, 2 heads, text_dim 12, patch_nums (1, 2, 4), a 4-bit BSQ
tokenizer) with non-zero biases and a LoRA adapter on every target,
carried over leaf by leaf (``weights.from_jax.infinity_from_jax``); text
features from numpy with a seed; JAX's own sampling noise injected: image
``i`` at scale ``si`` takes ``jax.random.gumbel(fold_in(fold_in(key, si),
i), (pn², bits, 2))``, which is what ``jax.random.categorical`` adds. The
JAX side runs ``decode_attention`` as the JAX tests run it on the CPU.

- ``apply_rope``, ``rope2d_pyramid``, every ``bsq`` function (the native
  and the CompVis ``decode_img``) and ``precompute_cross_kv``: within 1e-4
  (measured ≤ 5.4e-7).
- ``generate`` over the attention flags (off; the released QK-l2 + 2D RoPE +
  QK-l2 cross-attention) and the cfg/τ schedules (defaults; per-scale
  lists): bits equal exactly, and justified: at every sampled bit the gap
  between its two ``lg + gumbel`` exceeds 100× the measured logit error
  (the port's guided logits against the JAX package's on the same bit
  sequence; measured ≤ 1.9e-6, smallest gap 9.1e-4). f̂ and images within
  3e-4 (measured: f̂ 0, images ≤ 2.7e-7).
- Garbage in the padded text positions changes nothing; the JAX
  ``save_infinity_cache`` file and a reference ``.pt`` payload load to the
  same arrays and sha256 in the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.lora import LoRASpec as JSpec
from hyperscalees_t2i_tpu.lora import init_lora as jinit_lora
from hyperscalees_t2i_tpu.lora import lookup as jlookup
from hyperscalees_t2i_tpu.lora import slice_layer as jslice_layer
from hyperscalees_t2i_tpu.models import bsq as jbsq
from hyperscalees_t2i_tpu.models import infinity as jinf
from hyperscalees_t2i_tpu.models import msvq as jmsvq
from hyperscalees_t2i_tpu.models import nn as jnn
from hyperscalees_t2i_tpu.utils import prompt_cache as jpc
from hyperscalees_t2i_tpu_torch.lora import stack_adapters
from hyperscalees_t2i_tpu_torch.models import bsq, infinity, msvq, nn
from hyperscalees_t2i_tpu_torch.rungs import infinity_rung_model
from hyperscalees_t2i_tpu_torch.utils import prompt_cache as pc
from hyperscalees_t2i_tpu_torch.backends.infinity_backend import hash_text_features
from hyperscalees_t2i_tpu_torch.ops.sampling import per_scale_gumbel
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.utils.seeding import stable_text_seed
from hyperscalees_t2i_tpu_torch.weights.from_jax import adapter_from_jax, bsq_from_jax, infinity_from_jax

from test_torch_threefry import assert_tree_matches_jax

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
PRIM = dict(rtol=1e-4, atol=1e-4)
FLAGS = {"plain": {}, "released": dict(attn_l2_norm=True, use_rope2d=True, cross_attn_l2_norm=True)}
SCHEDULES = {"defaults": (None, None), "lists": ((2.0, 5.0, 0.5), (0.8, 0.3))}
MASK = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], bool)
LORA_SCALE = 2.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tiny_vq():
    return jbsq.BSQConfig(bits=4, patch_nums=(1, 2, 4), phi_partial=2, dec_ch=(8, 8), dec_blocks=1,
                          compute_dtype=jnp.float32)


def tiny_cfg(**kw):
    return jinf.InfinityConfig(depth=2, d_model=16, n_heads=2, ff_ratio=2.0, text_dim=12, patch_nums=(1, 2, 4),
                               vq=tiny_vq(), compute_dtype=jnp.float32, **kw)


def port_vq(j):
    return bsq.BSQConfig(bits=j.bits, patch_nums=j.patch_nums, phi_partial=j.phi_partial, dec_ch=j.dec_ch,
                         dec_blocks=j.dec_blocks, compute_dtype=torch.float32)


def port_cfg(j):
    kw = {f.name: getattr(j, f.name) for f in dataclasses.fields(j) if f.name not in ("vq", "compute_dtype")}
    return infinity.InfinityConfig(**kw, vq=port_vq(j.vq), compute_dtype=torch.float32)


def jax_params(cfg, seed=0):
    """Random JAX parameters with every non-kernel leaf perturbed (non-zero
    biases, norm affines, scales, embeddings)."""
    params = jinf.init_infinity(jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a if "kernel" in jax.tree_util.keystr(path)
        else a + 0.05 * jax.random.normal(jax.random.PRNGKey(a.size), a.shape), params)


def jax_adapter(params, seed):
    theta = jinit_lora(jax.random.PRNGKey(seed), params, JSpec(4, 8.0, jinf.INFINITY_LORA_TARGETS))
    return jax.tree_util.tree_map(lambda a: a + 0.2 * jax.random.normal(jax.random.PRNGKey(seed + 1), a.shape), theta)


def jax_gumbel(key, cfg, n_images):
    """``[n_images, L, bits, 2]``: what JAX's generate adds to image i's logits."""
    return np.array(jnp.stack([jnp.concatenate([
        jax.random.gumbel(jax.random.fold_in(jax.random.fold_in(key, si), i), (pn * pn, cfg.vq.bits, 2))
        for si, pn in enumerate(cfg.patch_nums)]) for i in range(n_images)]))


def text_inputs(cfg, seed=5):
    emb = np.random.RandomState(seed).randn(len(MASK), MASK.shape[1], cfg.text_dim).astype(np.float32)
    return emb, MASK.copy()


def jax_guided_logits(params, cfg, emb, mask, bits, cfg_list, tau_list, lora, lora_scale):
    """The JAX package's guided, tempered logits ``[B, L, bits, 2]`` of every
    scale on a given bit sequence (``generate``'s loop with the sampled bits
    replaced by ``bits [B, L, bits]``), from its own ``_blocks_step``."""
    B, d, S = emb.shape[0], cfg.d_model, len(cfg.patch_nums)
    L, C, H, dh = cfg.seq_len, cfg.vq.bits, cfg.n_heads, cfg.head_dim
    cfgs, taus = jinf._schedule(cfg_list, cfg.cfg_scale, S), jinf._schedule(tau_list, cfg.tau, S)
    txt = jnn.dense(params["text_proj"], jnp.asarray(emb))
    txt = jnp.concatenate([jnp.broadcast_to(params["null_text"], (B, 1, d)), txt], axis=1)
    m = jnp.concatenate([jnp.ones((B, 1), bool), jnp.asarray(mask)], axis=1)
    txt2 = jnp.concatenate([txt, txt], axis=0)
    mask2 = jnp.concatenate([m, jnp.pad(jnp.ones((B, 1), bool), ((0, 0), (0, m.shape[1] - 1)))], axis=0)
    pooled = (txt2 * mask2[..., None]).sum(1) / jnp.maximum(mask2.sum(-1, keepdims=True), 1).astype(jnp.float32)
    cond = jnn.dense(params["pool_proj"], pooled)
    ada = params["blocks"]["ada_lin"]
    cond6 = (jnp.einsum("bd,lde->lbe", jax.nn.silu(cond), ada["kernel"]) + ada["bias"][:, None, :]).reshape(
        cfg.depth, 2 * B, 6, d)
    caches = (jnp.zeros((cfg.depth, 2 * B, L, H, dh)), jnp.zeros((cfg.depth, 2 * B, L, H, dh)))
    f_hat = jnp.zeros((B, cfg.vq.grid, cfg.vq.grid, C))
    rope = jinf.rope2d_pyramid(cfg) if cfg.use_rope2d else None
    cross_kv = jinf.precompute_cross_kv(params, cfg, txt2, lora, lora_scale)
    x = cond[:, None, :] + params["pos_start"] + params["lvl_emb"][0][None, None, :] + params["pos_emb"][None, :1, :]
    out = []
    for si, (pos, n) in enumerate(jinf._scale_slices(cfg.patch_nums)):
        h, caches = jinf._blocks_step(params, cfg, x, cond6, cross_kv, mask2, caches, pos, lora, lora_scale, rope=rope)
        logits = jnn.dense(params["head"], jnn.layer_norm(h, params["head_norm"])).reshape(2 * B, n, C, 2)
        t = cfgs[si]
        out.append(np.asarray(((1.0 + t) * logits[:B] - t * logits[B:]) / max(taus[si], 1e-5)))
        f_hat, nxt = jbsq.accumulate_scale(params["vq"], cfg.vq, f_hat, jnp.asarray(bits[:, pos:pos + n]), si)
        if si + 1 < S:
            n1 = cfg.patch_nums[si + 1] ** 2
            emb1 = jnn.dense(params["word_embed"], nxt.reshape(B, n1, C))
            nxt_x = emb1 + params["lvl_emb"][si + 1][None, None, :] + params["pos_emb"][None, pos + n:pos + n + n1, :]
            x = jnp.concatenate([nxt_x, nxt_x])
    return np.concatenate(out, axis=1)


class _Record:
    """Wraps ``models.infinity.sample_bits``: keeps each scale's guided
    logits, noise and bits."""

    def __init__(self):
        self.orig, self.calls = infinity.sample_bits, []

    def __enter__(self):
        def rec(lg, gumbel):
            bits = self.orig(lg, gumbel)
            self.calls.append((lg.clone(), gumbel.clone(), bits.clone()))
            return bits

        infinity.sample_bits = rec
        return self

    def __exit__(self, *exc):
        infinity.sample_bits = self.orig


def port_generate(model, thetas, emb, mask, gumbel, cfg_list=None, tau_list=None, decode=True):
    n = len(thetas)
    lora = stack_adapters([adapter_from_jax(_np(t), "cpu") for t in thetas])
    with torch.inference_mode():
        return infinity.generate(model, torch.from_numpy(emb).reshape(n, -1, *emb.shape[1:]),
                                 torch.from_numpy(mask).reshape(n, -1, mask.shape[1]),
                                 torch.from_numpy(gumbel).reshape(n, -1, *gumbel.shape[1:]),
                                 cfg_list=cfg_list, tau_list=tau_list, lora=lora, lora_scale=LORA_SCALE,
                                 decode=decode)


# -- primitives ----------------------------------------------------------------

def test_apply_rope_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 7, 3, 8).astype(np.float32)
    cos, sin = rs.randn(7, 4).astype(np.float32), rs.randn(7, 4).astype(np.float32)
    ref = np.asarray(jnn.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin)))
    out = nn.apply_rope(*(torch.from_numpy(a) for a in (x, cos, sin))).numpy()
    np.testing.assert_allclose(out, ref, **PRIM)


@pytest.mark.parametrize("pn", ["tiny", "0.25M", "1M"])
def test_rope2d_pyramid_matches_jax(pn):
    jcfg = tiny_cfg(use_rope2d=True) if pn == "tiny" else jinf.InfinityConfig(
        d_model=64, n_heads=4, patch_nums=jinf.PN_PRESETS[pn], compute_dtype=jnp.float32)
    cos, sin = infinity.rope2d_pyramid(port_cfg(jcfg))
    jcos, jsin = jinf.rope2d_pyramid(jcfg)
    assert cos.dtype == torch.float32 and tuple(cos.shape) == (jcfg.seq_len, jcfg.head_dim // 2)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **PRIM)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **PRIM)


def test_presets_schedules_and_released_config():
    assert infinity.INFINITY_PRESETS == jinf.INFINITY_PRESETS and infinity.PN_PRESETS == jinf.PN_PRESETS
    for vals, default, S in ((None, 3.0, 4), ([1.0, 2.0], 0.0, 4), ([1.0, 2.0, 3.0, 4.0, 5.0], 0.0, 3),
                             (2.5, 0.0, 2), ((0.8,), 0.5, 3)):
        assert infinity.schedule(vals, default, S) == jinf._schedule(vals, default, S)
    assert infinity.scale_slices((1, 2, 4)) == jinf._scale_slices((1, 2, 4))
    j, p = jinf.InfinityConfig(), infinity.InfinityConfig()
    assert port_cfg(dataclasses.replace(j, compute_dtype=jnp.float32)) == dataclasses.replace(
        p, compute_dtype=torch.float32, vq=dataclasses.replace(p.vq, compute_dtype=torch.float32))
    m = infinity.released_config("2b", "1M")
    assert (m.depth, m.d_model, m.n_heads, m.head_dim, m.text_dim, m.seq_len) == (32, 2048, 16, 128, 2048, 9451)
    assert m.attn_l2_norm and m.use_rope2d and m.cross_attn_l2_norm
    assert m.vq.bits == 32 and m.vq.patch_nums == m.patch_nums == jinf.PN_PRESETS["1M"] and m.vq.grid == 64
    assert infinity_rung_model("2b")["bcfg"].model == m
    with pytest.raises(ValueError, match="no released configuration"):
        infinity.released_config("8b", "1M")
    tiny = infinity_rung_model("tiny")["bcfg"].model
    assert tiny == port_cfg(tiny_cfg())


@pytest.mark.parametrize("released", [False, True])
def test_init_infinity_matches_jax_leaf_by_leaf(released):
    kw = dict(attn_l2_norm=True, use_rope2d=True, cross_attn_l2_norm=True) if released else {}
    j = tiny_cfg(**kw)
    assert_tree_matches_jax(jinf.init_infinity(jax.random.PRNGKey(3), j), infinity.init_infinity(port_cfg(j),
                                                                                              threefry.prng_key(3, "cpu")))


def test_init_bsq_matches_jax_leaf_by_leaf():
    j = jbsq.BSQConfig(bits=4, patch_nums=(1, 2, 4), phi_partial=2, dec_ch=(8, 4), dec_blocks=2,
                       compute_dtype=jnp.float32)
    assert_tree_matches_jax(jbsq.init_bsq(jax.random.PRNGKey(2), j), bsq.init_bsq(port_vq(j), threefry.prng_key(2, "cpu")))


def test_gumbel_and_hash_text_features_are_the_jax_draws():
    cfg = tiny_cfg()
    g = per_scale_gumbel(threefry.prng_key(8, "cpu"), [0, 1, 2], cfg.patch_nums, (cfg.vq.bits, 2))
    np.testing.assert_allclose(g.numpy(), jax_gumbel(jax.random.PRNGKey(8), cfg, 3), rtol=0, atol=1e-6)
    prompts = ["a red square", "a blue circle", "", "a green cat"]
    emb, mask = hash_text_features(prompts, 12, torch.device("cpu"))
    for i, p in enumerate(prompts):  # the JAX backend's hash fallback
        k = jax.random.fold_in(jax.random.PRNGKey(777), stable_text_seed(p))
        np.testing.assert_allclose(emb[i].numpy(), np.asarray(jax.random.normal(k, (16, 12))), rtol=0, atol=1e-6)
        assert mask[i].tolist() == [t < 16 - (i % 3) for t in range(16)]


# -- BSQ -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def vq_pair():
    cfg = tiny_vq()
    params = jbsq.init_bsq(jax.random.PRNGKey(0), cfg)
    params = jax.tree_util.tree_map(lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(a.size), a.shape)
                                    if a.ndim <= 2 else a, params)
    return cfg, params, bsq_from_jax(_np(params), port_vq(cfg), "cpu")


def test_bsq_bits_vec_and_phi_index():
    bits = np.random.RandomState(1).randint(0, 2, (3, 5, 4)).astype(np.int32)
    v = bsq.bits_to_vec(torch.from_numpy(bits), 4)
    np.testing.assert_allclose(v.numpy(), np.asarray(jbsq.bits_to_vec(jnp.asarray(bits), 4)), **PRIM)
    np.testing.assert_array_equal(bsq.vec_to_bits(v).numpy(), np.asarray(jbsq.vec_to_bits(jnp.asarray(v.numpy()))))
    for S in (1, 2, 3, 10, 14):
        for K in (1, 2, 4):
            j = dataclasses.replace(tiny_vq(), patch_nums=tuple(range(1, S + 1)), phi_partial=K)
            assert [bsq.phi_index(port_vq(j), si) for si in range(S)] == [jbsq.phi_index(j, si) for si in range(S)]


def test_bsq_accumulate_and_encode_match_jax(vq_pair):
    cfg, params, vq = vq_pair
    rs = np.random.RandomState(2)
    f = rs.randn(2, cfg.grid, cfg.grid, cfg.bits).astype(np.float32)
    jenc, jf = jbsq.encode_to_scales(params, cfg, jnp.asarray(f))
    enc, tf = bsq.encode_to_scales(vq, torch.from_numpy(f))
    for a, b in zip(enc, jenc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **PRIM)
    f_hat = rs.randn(2, cfg.grid, cfg.grid, cfg.bits).astype(np.float32)
    for si, pn in enumerate(cfg.patch_nums):
        bits = rs.randint(0, 2, (2, pn * pn, cfg.bits)).astype(np.int32)
        jout = jbsq.accumulate_scale(params, cfg, jnp.asarray(f_hat), jnp.asarray(bits), si)
        out = bsq.accumulate_scale(vq, torch.from_numpy(f_hat), torch.from_numpy(bits), si)
        for a, b in zip(out, jout):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **PRIM)
        h = torch.from_numpy(f_hat)
        np.testing.assert_allclose(bsq.phi_apply(vq, h, si).numpy(),
                                   np.asarray(jbsq.phi_apply(params, cfg, jnp.asarray(f_hat), si)), **PRIM)


@pytest.mark.parametrize("decoder", ["native", "compvis"])
def test_bsq_decode_img_matches_jax(vq_pair, decoder):
    cfg, params, vq = vq_pair
    if decoder == "compvis":
        # a converted CompVis tokenizer decoder: the subtree carries "mid"
        mcfg = jmsvq.MSVQConfig(vocab_size=16, c_vae=cfg.bits, patch_nums=cfg.patch_nums, phi_partial=2, ch=8,
                                ch_mult=(1, 1), num_res_blocks=1, compute_dtype=jnp.float32)
        params = dict(params, decoder=jmsvq.init_msvq(jax.random.PRNGKey(4), mcfg)["decoder"])
        vq = bsq_from_jax(_np(params), port_vq(cfg), "cpu")
        assert isinstance(vq.decoder, msvq.CompVisDecoder)
    f_hat = np.random.RandomState(3).randn(2, cfg.grid, cfg.grid, cfg.bits).astype(np.float32)
    ref = np.asarray(jbsq.decode_img(params, cfg, jnp.asarray(f_hat)))
    with torch.inference_mode():
        out = bsq.decode_img(vq, torch.from_numpy(f_hat)).numpy()
    assert out.shape == ref.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(out, ref, **PRIM)


# -- the transformer -----------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(FLAGS))
def model_pair(request):
    cfg = tiny_cfg(**FLAGS[request.param])
    params = jax_params(cfg)
    return dict(cfg=cfg, params=params, theta=jax_adapter(params, 10), theta2=jax_adapter(params, 20),
                model=infinity_from_jax(_np(params), port_cfg(cfg), "cpu"))


def test_precompute_cross_kv_matches_jax(model_pair):
    s = model_pair
    rs = np.random.RandomState(6)
    txt = rs.randn(4, 6, s["cfg"].d_model).astype(np.float32)
    jck, jcv = jinf.precompute_cross_kv(s["params"], s["cfg"], jnp.asarray(txt), s["theta"], LORA_SCALE)
    with torch.inference_mode():
        ck, cv = infinity.precompute_cross_kv(s["model"], torch.from_numpy(txt), adapter_from_jax(_np(s["theta"]), "cpu"),
                                              LORA_SCALE)
    for i in range(s["cfg"].depth):
        np.testing.assert_allclose(ck[i].numpy(), np.asarray(jck[i]), **PRIM)
        np.testing.assert_allclose(cv[i].numpy(), np.asarray(jcv[i]), **PRIM)
    lo = jslice_layer(jlookup(s["theta"], "blocks/cross_kv"), 1)
    assert lo is not None and float(jnp.abs(lo["b"]).max()) > 0  # the adapter reaches the text projections


@pytest.fixture(scope="module", params=sorted(SCHEDULES))
def run(request, model_pair):
    s = model_pair
    cfg_list, tau_list = SCHEDULES[request.param]
    emb, mask = text_inputs(s["cfg"])
    key = jax.random.PRNGKey(7)
    gumbel = jax_gumbel(key, s["cfg"], len(emb))
    jkw = dict(cfg_list=cfg_list, tau_list=tau_list, lora=s["theta"], lora_scale=LORA_SCALE)
    jf = np.asarray(jinf.generate(s["params"], s["cfg"], jnp.asarray(emb), jnp.asarray(mask), key, decode=False, **jkw))
    jimg = np.asarray(jinf.generate(s["params"], s["cfg"], jnp.asarray(emb), jnp.asarray(mask), key, **jkw))
    with _Record() as rec:
        tf = port_generate(s["model"], [s["theta"]], emb, mask, gumbel, cfg_list, tau_list, decode=False)[0]
    timg = port_generate(s["model"], [s["theta"]], emb, mask, gumbel, cfg_list, tau_list)[0]
    return dict(s=s, emb=emb, mask=mask, gumbel=gumbel, cfg_list=cfg_list, tau_list=tau_list, jf=jf, jimg=jimg,
                tf=tf.numpy(), timg=timg.numpy(), rec=rec.calls)


def test_bits_exact_under_a_measured_margin(run):
    s, rec = run["s"], run["rec"]
    B = len(run["emb"])
    bits = np.concatenate([c[2].reshape(B, -1, s["cfg"].vq.bits).numpy() for c in rec], axis=1)
    port_lg = np.concatenate([c[0].reshape(B, -1, s["cfg"].vq.bits, 2).numpy() for c in rec], axis=1)
    jax_lg = jax_guided_logits(s["params"], s["cfg"], run["emb"], run["mask"], bits, run["cfg_list"],
                               run["tau_list"], s["theta"], LORA_SCALE)
    logit_err = float(np.abs(port_lg - jax_lg).max())
    np.testing.assert_array_equal(bits, np.argmax(jax_lg + run["gumbel"], axis=-1))
    z = port_lg + run["gumbel"]
    gap = float(np.abs(z[..., 1] - z[..., 0]).min())
    assert logit_err < 1e-5 and gap > 100 * logit_err, (logit_err, gap)


def test_f_hat_and_images_match_jax(run):
    np.testing.assert_allclose(run["tf"], run["jf"], **TOL)
    assert run["timg"].shape == run["jimg"].shape == (len(run["emb"]), 8, 8, 3)
    np.testing.assert_allclose(run["timg"], run["jimg"], **TOL)
    assert np.isfinite(run["timg"]).all()


def test_padding_invariance_and_lanes(model_pair):
    """Garbage in a row's padded text positions changes nothing; two lanes
    with different adapters equal each adapter alone."""
    s = model_pair
    emb, mask = text_inputs(s["cfg"])
    gumbel = jax_gumbel(jax.random.PRNGKey(8), s["cfg"], 4)
    emb4, mask4 = np.concatenate([emb, emb[:1]]), np.concatenate([mask, mask[:1]])
    f1 = port_generate(s["model"], [s["theta"]], emb4, mask4, gumbel, decode=False)
    emb_g = emb4.copy()
    emb_g[0, 3:] = 1e3
    emb_g[2, 1:] = -1e3
    f2 = port_generate(s["model"], [s["theta"]], emb_g, mask4, gumbel, decode=False)
    np.testing.assert_allclose(f1.numpy(), f2.numpy(), rtol=1e-5, atol=1e-5)
    both = port_generate(s["model"], [s["theta"], s["theta2"]], emb4, mask4, gumbel)
    a = port_generate(s["model"], [s["theta"]], emb4[:2], mask4[:2], gumbel[:2])[0]
    b = port_generate(s["model"], [s["theta2"]], emb4[2:], mask4[2:], gumbel[2:])[0]
    np.testing.assert_allclose(both[0].numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(both[1].numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    assert float((both[0] - both[1]).abs().max()) > 0


# -- the prompt cache ----------------------------------------------------------

def test_infinity_cache_npz_from_jax(tmp_path):
    path = str(tmp_path / "sub" / "inf_cache.npz")
    emb = np.random.RandomState(9).randn(3, 5, 12).astype(np.float32)
    jpc.save_infinity_cache(path, ["a cat", "a dog", "a man"], emb, MASK)
    data = pc.load_cache(path, "infinity")
    jdata = jpc.load_cache(path, "infinity")
    assert data["prompts"] == jdata["prompts"] == ["a cat", "a dog", "a man"]
    np.testing.assert_array_equal(data["text_emb"], jdata["text_emb"])
    np.testing.assert_array_equal(data["text_mask"], jdata["text_mask"])
    assert data["content_sha256"] == jdata["content_sha256"] == pc.file_sha256(path) == jpc.file_sha256(path)
    assert data["cache_backend"] == "infinity"
    # the port's writer makes a file the JAX loader reads to the same arrays
    path2 = str(tmp_path / "port.npz")
    pc.save_infinity_cache(path2, data["prompts"], data["text_emb"], data["text_mask"])
    again = jpc.load_infinity_cache(path2)
    np.testing.assert_array_equal(again["text_emb"], emb)
    np.testing.assert_array_equal(again["text_mask"], MASK)


def test_infinity_cache_pt_payload(tmp_path):
    path = tmp_path / "inf_cache.pt"
    g = torch.Generator().manual_seed(0)
    torch.save({"prompts": ["a", "bb"], "kv_compact_list": [torch.randn(3, 12, generator=g),
                                                             torch.randn(7, 12, generator=g)],
                "lens_list": [3, 7]}, path)
    for max_len in (0, 5):
        data, jdata = pc.load_infinity_cache(str(path), max_len), jpc.load_infinity_cache(str(path), max_len)
        assert data["prompts"] == jdata["prompts"]
        np.testing.assert_array_equal(data["text_emb"], jdata["text_emb"])
        np.testing.assert_array_equal(data["text_mask"], jdata["text_mask"])
    assert pc.load_cache(str(path), "infinity")["content_sha256"] == jpc.file_sha256(str(path))


def test_prompt_helpers_match_jax(tmp_path):
    for p in ("a humane robot", "a red square", "two women talking", ""):
        assert pc.aug_with_positive_prompt(p) == jpc.aug_with_positive_prompt(p)
    txt = tmp_path / "p.txt"
    txt.write_text("# header\n  one \n\ntwo\n#skip\nthree\n")
    assert pc.load_prompts_txt(str(txt)) == jpc.load_prompts_txt(str(txt)) == ["one", "two", "three"]
    arrs = [np.ones((2, 3)), np.full((4, 3), 2.0)]
    for lens, max_len in ((None, 0), ([1, 4], 3)):
        for a, b in zip(pc.pad_ragged(arrs, lens, max_len), jpc.pad_ragged(arrs, lens, max_len)):
            np.testing.assert_array_equal(a, b)
    for name in ("infinity", "sana_one_step", "sana_pipeline", "zimage"):
        assert pc.cache_backend_key(name) == jpc.cache_backend_key(name)
    with pytest.raises(ValueError, match="class-conditional"):
        pc.cache_backend_key("var")
    # the zimage kind: a cache either package wrote loads the same in both
    zc = tmp_path / "zimage.npz"
    pc.save_zimage_cache(str(zc), ["one", "two"], np.ones((2, 3, 4), np.float32), np.ones((2, 3), bool))
    got, want = pc.load_cache(str(zc), "zimage"), jpc.load_cache(str(zc), "zimage")
    assert got["prompts"] == want["prompts"] == ["one", "two"] and got["content_sha256"] == want["content_sha256"]
    for k in ("prompt_embeds", "prompt_mask"):
        np.testing.assert_array_equal(got[k], want[k])
