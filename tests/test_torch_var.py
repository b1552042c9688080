"""Port parity: VAR next-scale generation at the tiny geometry, f32.

The JAX package's tiny VAR (``train/cli.py --model_scale tiny``: depth 2,
d 32, 4 heads, patch_nums (1, 2, 4), vocab 64) with a LoRA adapter on every
target, carried over leaf by leaf; JAX's own sampling noise is injected:
image ``i`` at scale ``si`` takes ``jax.random.gumbel(fold_in(fold_in(key,
si), i), (pn², V))``, which is what ``jax.random.categorical`` adds.

- Token ids equal exactly. That is justified, not lucky: at every sampled
  position the gap between the best and second-best ``filtered + gumbel``
  exceeds 100× the measured logit error (the port's KV-cached logits
  against the JAX package's teacher-forced ones on the sampled sequence,
  after the CFG ramp; measured ≤ 7.2e-7, smallest gap 6.2e-4).
- f̂ and images within 3e-4 (measured ≤ 2.4e-6), with and without
  top-k/top-p.
- The port's KV-cached path equals its ``forward_teacher`` within 1e-5.
- Two lanes with different adapters equal each adapter alone; four images
  in one call equal two calls of two (rtol/atol 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.lora import LoRASpec as JSpec
from hyperscalees_t2i_tpu.lora import init_lora as jinit_lora
from hyperscalees_t2i_tpu.models import msvq as jmsvq
from hyperscalees_t2i_tpu.models import var as jvar
from hyperscalees_t2i_tpu.ops.sampling import filter_top_k as jfilter_top_k
from hyperscalees_t2i_tpu.ops.sampling import filter_top_p as jfilter_top_p
from hyperscalees_t2i_tpu_torch.backends.var_backend import VarBackend
from hyperscalees_t2i_tpu_torch.lora import stack_adapters
from hyperscalees_t2i_tpu_torch.models import msvq, var
from hyperscalees_t2i_tpu_torch.ops.sampling import filter_top_k, filter_top_p, per_scale_gumbel
from hyperscalees_t2i_tpu_torch.rungs import var_rung_model
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.weights.from_jax import adapter_from_jax, tree_from_numpy, var_from_jax

from test_torch_threefry import assert_tree_matches_jax

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
LABELS = np.array([3, 7, 0, 9])
CFG_SCALE = 4.0
SAMPLERS = {"no_filter": (0, 0.0), "top_k_top_p": (16, 0.9), "backend_default": (900, 0.96)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_cfg():
    vq = jmsvq.MSVQConfig(vocab_size=64, c_vae=8, patch_nums=(1, 2, 4), phi_partial=2, ch=8, ch_mult=(1, 1),
                          num_res_blocks=1, compute_dtype=jnp.float32)
    return jvar.VARConfig(vq=vq, num_classes=10, depth=2, d_model=32, n_heads=4, ff_ratio=2.0, patch_nums=(1, 2, 4),
                          compute_dtype=jnp.float32, top_k=0, top_p=0.0)


def _jax_adapter(params, cfg, seed):
    theta = jinit_lora(jax.random.PRNGKey(seed), params, JSpec(8, 16.0, jvar.VAR_LORA_TARGETS))
    return jax.tree_util.tree_map(lambda a: a + 0.2 * jax.random.normal(jax.random.PRNGKey(seed + 1), a.shape), theta)


def jax_gumbel(key, cfg, n_images):
    """``[n_images, L, V]``: what JAX's generate adds to image i's logits."""
    out = []
    for i in range(n_images):
        out.append(jnp.concatenate([
            jax.random.gumbel(jax.random.fold_in(jax.random.fold_in(key, si), i), (pn * pn, cfg.vq.vocab_size))
            for si, pn in enumerate(cfg.patch_nums)]))
    return np.array(jnp.stack(out))


class _Record:
    """Wraps ``models.var.sample_top_k_top_p``: keeps each scale's CFG-mixed
    logits, noise and ids."""

    def __init__(self):
        self.orig, self.calls = var.sample_top_k_top_p, []

    def __enter__(self):
        def rec(lg, gumbel, **kw):
            ids = self.orig(lg, gumbel, **kw)
            self.calls.append((lg.clone(), gumbel.clone(), ids.clone(), kw))
            return ids

        var.sample_top_k_top_p = rec
        return self

    def __exit__(self, *exc):
        var.sample_top_k_top_p = self.orig


def _scale_inputs(tmodel, ids_per_scale):
    """The teacher-forced next-scale inputs ``[B, L, C]`` of a sampled
    sequence (scale si+1's positions hold f̂ after scale si, downsampled)."""
    cfg = tmodel.cfg
    B = ids_per_scale[0].shape[0]
    f_hat = torch.zeros(B, cfg.vq.grid, cfg.vq.grid, cfg.vq.c_vae)
    out = torch.zeros(B, cfg.seq_len, cfg.vq.c_vae)
    for si, (pos, n) in enumerate(var.scale_slices(cfg)):
        f_hat, nxt = msvq.accumulate_scale(tmodel.vq, f_hat, ids_per_scale[si], si)
        if si + 1 < len(cfg.patch_nums):
            p1, n1 = var.scale_slices(cfg)[si + 1]
            out[:, p1:p1 + n1] = nxt.reshape(B, n1, -1)
    return out


@pytest.fixture(scope="module")
def setup():
    cfg = _jax_cfg()
    params = jvar.init_var(jax.random.PRNGKey(0), cfg)
    params = jax.tree_util.tree_map(  # non-zero biases, norm affines and scales
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(a.size), a.shape) if a.ndim == 1 else a, params)
    theta = _jax_adapter(params, cfg, 10)
    theta2 = _jax_adapter(params, cfg, 20)
    tcfg = dataclasses.replace(var_rung_model("tiny")["bcfg"].model)
    tmodel = var_from_jax(_np(params), tcfg, "cpu")
    key = jax.random.PRNGKey(7)
    return dict(cfg=cfg, params=params, theta=theta, theta2=theta2, tmodel=tmodel, key=key,
                gumbel=jax_gumbel(key, cfg, len(LABELS)))


def _port_generate(s, thetas, labels, gumbel, tk, tp, decode=True):
    lora = stack_adapters([adapter_from_jax(_np(t), "cpu") for t in thetas])
    with torch.inference_mode():
        return var.generate(s["tmodel"], torch.as_tensor(labels).reshape(len(thetas), -1),
                            torch.from_numpy(gumbel).reshape(len(thetas), -1, *gumbel.shape[1:]),
                            cfg_scale=CFG_SCALE, top_k=tk, top_p=tp, lora=lora, lora_scale=2.0, decode=decode)


@pytest.fixture(scope="module", params=sorted(SAMPLERS))
def run(request, setup):
    s = setup
    tk, tp = SAMPLERS[request.param]
    jkw = dict(cfg_scale=CFG_SCALE, top_k=tk, top_p=tp, lora=s["theta"], lora_scale=2.0)
    jf = np.asarray(jvar.generate(s["params"], s["cfg"], jnp.asarray(LABELS), s["key"], decode=False, **jkw))
    jimg = np.asarray(jvar.generate(s["params"], s["cfg"], jnp.asarray(LABELS), s["key"], **jkw))
    with _Record() as rec:
        tf = _port_generate(s, [s["theta"]], LABELS, s["gumbel"], tk, tp, decode=False)[0]
    timg = _port_generate(s, [s["theta"]], LABELS, s["gumbel"], tk, tp)[0]
    return dict(s=s, tk=tk, tp=tp, jf=jf, jimg=jimg, tf=tf.numpy(), timg=timg.numpy(), rec=rec.calls)


def _cfg_mixed(logits_c, logits_u, cfg):
    """Per-scale CFG ramp over teacher logits ``[B, L, V]`` → ``[B, L, V]``."""
    S = len(cfg.patch_nums)
    out = []
    for si, (pos, n) in enumerate(jvar._scale_slices(cfg)):
        t = CFG_SCALE * si / max(S - 1, 1)
        out.append((1.0 + t) * logits_c[:, pos:pos + n] - t * logits_u[:, pos:pos + n])
    return np.concatenate(out, axis=1)


def test_token_ids_exact_under_a_measured_margin(run):
    s, rec, cfg = run["s"], run["rec"], run["s"]["cfg"]
    ids = [c[2].reshape(len(LABELS), -1) for c in rec]
    port_lg = np.concatenate([c[0].reshape(len(LABELS), -1, cfg.vq.vocab_size).numpy() for c in rec], axis=1)
    # the JAX package's logits on the sampled sequence (teacher-forced), mixed
    inputs = _scale_inputs(s["tmodel"], ids).numpy()
    uncond = np.full_like(LABELS, cfg.uncond_label)
    teach = lambda lbl: np.asarray(jvar.forward_teacher(  # noqa: E731
        s["params"], cfg, jnp.asarray(lbl), jnp.asarray(inputs), lora=s["theta"], lora_scale=2.0))
    jax_lg = _cfg_mixed(teach(LABELS), teach(uncond), cfg)
    logit_err = float(np.abs(port_lg - jax_lg).max())
    jfiltered = np.asarray(jfilter_top_p(jfilter_top_k(jnp.asarray(jax_lg), run["tk"]), run["tp"]))
    jids = np.argmax(jfiltered + s["gumbel"], axis=-1)
    np.testing.assert_array_equal(torch.cat(ids, dim=1).numpy(), jids)
    filtered = filter_top_p(filter_top_k(torch.from_numpy(port_lg), run["tk"]), run["tp"]).numpy()
    top2 = np.sort(filtered + s["gumbel"], axis=-1)[..., -2:]
    gap = float((top2[..., 1] - top2[..., 0]).min())
    assert logit_err < 1e-5 and gap > 100 * logit_err, (logit_err, gap)


def test_f_hat_and_images_match_jax(run):
    np.testing.assert_allclose(run["tf"], run["jf"], **TOL)
    assert run["timg"].shape == run["jimg"].shape == (len(LABELS), 8, 8, 3)
    np.testing.assert_allclose(run["timg"], run["jimg"], **TOL)


def test_kv_cached_path_matches_forward_teacher(run):
    s, rec, cfg = run["s"], run["rec"], run["s"]["cfg"]
    ids = [c[2].reshape(len(LABELS), -1) for c in rec]
    port_lg = np.concatenate([c[0].reshape(len(LABELS), -1, cfg.vq.vocab_size).numpy() for c in rec], axis=1)
    inputs = _scale_inputs(s["tmodel"], ids)
    lora = adapter_from_jax(_np(s["theta"]), "cpu")
    with torch.inference_mode():
        teach = lambda lbl: var.forward_teacher(s["tmodel"], torch.as_tensor(lbl), inputs, lora=lora,  # noqa: E731
                                                lora_scale=2.0).numpy()
        mixed = _cfg_mixed(teach(LABELS), teach(np.full_like(LABELS, cfg.uncond_label)), cfg)
    np.testing.assert_allclose(port_lg, mixed, rtol=1e-5, atol=1e-5)


def test_backend_draws_the_jax_gumbel_and_images(setup):
    """Nothing injected: the backend's Gumbel noise from a key is the JAX
    generate's (within 1e-6), and so are its images."""
    s = setup
    g = per_scale_gumbel(threefry.prng_key(7, "cpu"), range(len(LABELS)), s["cfg"].patch_nums, (s["cfg"].vq.vocab_size,))
    np.testing.assert_allclose(g.numpy(), s["gumbel"], rtol=0, atol=1e-6)
    backend = VarBackend(var_rung_model("tiny")["bcfg"], "cpu", params=tree_from_numpy(_np(s["params"]), "cpu"))
    backend.setup()
    bc = backend.cfg
    with torch.inference_mode():
        timg = backend.generate(adapter_from_jax(_np(s["theta"]), "cpu"), LABELS.tolist(), threefry.prng_key(7, "cpu"))
    jimg = jvar.generate(s["params"], s["cfg"], jnp.asarray(LABELS), s["key"], cfg_scale=bc.cfg_scale,
                         top_k=bc.top_k, top_p=bc.top_p, lora=s["theta"], lora_scale=backend.lora_scale)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), **TOL)


def test_lanes_with_different_adapters_equal_each_alone(setup):
    s = setup
    tk, tp = SAMPLERS["top_k_top_p"]
    both = _port_generate(s, [s["theta"], s["theta2"]], LABELS, s["gumbel"], tk, tp)
    a = _port_generate(s, [s["theta"]], LABELS[:2], s["gumbel"][:2], tk, tp)[0]
    b = _port_generate(s, [s["theta2"]], LABELS[2:], s["gumbel"][2:], tk, tp)[0]
    np.testing.assert_allclose(both[0].numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(both[1].numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    assert float((both[0] - both[1]).abs().max()) > 0


def test_chunked_equals_whole(setup):
    s = setup
    tk, tp = SAMPLERS["no_filter"]
    whole = _port_generate(s, [s["theta"]], LABELS, s["gumbel"], tk, tp)[0]
    parts = [_port_generate(s, [s["theta"]], LABELS[i:i + 2], s["gumbel"][i:i + 2], tk, tp)[0] for i in (0, 2)]
    np.testing.assert_allclose(whole.numpy(), torch.cat(parts).numpy(), rtol=1e-5, atol=1e-5)


def test_backend_seeded_noise_depends_on_seed_and_image_only():
    """A served lane: image j draws its Gumbel noise from (key, j) only, so
    two images of a request equal the first two of a longer one."""
    bcfg = var_rung_model("tiny")["bcfg"]
    backend = VarBackend(bcfg, "cpu")
    backend.setup()
    theta = backend.init_theta(threefry.prng_key(0, "cpu"))
    with torch.inference_mode():
        four = backend.generate(theta, [0, 1, 2, 3], threefry.prng_key(5, "cpu"))
        two = backend.generate(theta, [0, 1], threefry.prng_key(5, "cpu"))
        other = backend.generate(theta, [0, 1], threefry.prng_key(6, "cpu"))
    assert four.shape == (4, 8, 8, 3) and bool(torch.isfinite(four).all())
    np.testing.assert_allclose(four[:2].numpy(), two.numpy(), rtol=1e-5, atol=1e-5)
    assert float((other - two).abs().max()) > 0
    assert backend.texts[3] == "a photo of class_3" and backend.noise_shape == (21, 64)


def test_init_var_builds_the_jax_tree_structure():
    cfg = _jax_cfg()
    tcfg = var_rung_model("tiny")["bcfg"].model
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jvar.init_var(jax.random.PRNGKey(0), cfg))
    ttree = var.init_var(tcfg, threefry.prng_key(0, "cpu"))
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ttree)
    assert jshapes == tshapes
    assert_tree_matches_jax(jvar.init_var(jax.random.PRNGKey(0), cfg), ttree)
    assert tcfg.seq_len == cfg.seq_len and tcfg.head_dim == cfg.head_dim
