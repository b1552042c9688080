"""The Sana pipeline mode (multi-step TrigFlow consistency sampling) against
the JAX package on the CPU.

- The timesteps equal ``jnp.linspace(1.5708, 0, num_steps + 1)`` bitwise
  for ``num_steps`` 1-8 (XLA multiplies by the reciprocal of the step
  count; ``torch.linspace`` would differ in the last ulp).
- The pipeline's draws: every key of the ``split`` chain, and each draw's
  bits and uniforms, equal the JAX key tree's bitwise; the normals within
  1e-6.
- ``multistep_generate`` from a key (nothing injected, float and int8
  base) and the backend's ``generate_p`` in pipeline mode agree with JAX
  within 3e-4 (the golden bound).
- A tiny ``run_training`` with the pipeline backend from a seed (weights,
  prompt embeddings, θ₀, ES noise and every pipeline draw made by the port)
  against the JAX ``run_training``: every shared ``metrics.jsonl`` value and
  the epoch-2 slot's θ within 3e-4, nothing injected.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.backends.sana_backend import SanaBackend as JSanaBackend
from hyperscalees_t2i_tpu.backends.sana_backend import SanaBackendConfig as JSanaBackendConfig
from hyperscalees_t2i_tpu.lora import init_lora as jinit_lora
from hyperscalees_t2i_tpu.models import dcae as jdcae
from hyperscalees_t2i_tpu.models import sana as jsana
from hyperscalees_t2i_tpu.ops.quant import quantize_tree as jquantize_tree
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import run_training as jrun_training
from hyperscalees_t2i_tpu_torch.backends.sana_backend import SanaBackend, SanaBackendConfig
from hyperscalees_t2i_tpu_torch.models import dcae, sana
from hyperscalees_t2i_tpu_torch.train import trainer
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows
from hyperscalees_t2i_tpu_torch.weights.from_jax import adapter_from_jax, sana_from_jax, tree_from_numpy

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
SANA_KW = dict(in_channels=4, out_channels=4, d_model=32, n_layers=2, n_heads=4, cross_n_heads=4, caption_dim=16,
               ff_ratio=2.0)
CLOCK_KEYS = {"ts", "step_time_s", "images_per_sec", "obs/compile_cache_entries"}


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _jax_chain(key, num_steps):
    """The JAX ``multistep_generate``'s noise keys: ``key, n = split(key)``
    once for the latents, then once a step."""
    out = []
    for _ in range(num_steps + 1):
        key, nkey = jax.random.split(key)
        out.append(nkey)
    return out


@pytest.mark.parametrize("num_steps", range(1, 9))
def test_timesteps_equal_jnp_linspace_bitwise(num_steps):
    ours = np.array(sana.pipeline_timesteps(num_steps), np.float32)
    theirs = np.asarray(jnp.linspace(1.57080, 0.0, num_steps + 1))
    assert theirs.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.uint32), theirs.view(np.uint32))


@pytest.mark.parametrize("num_steps", [1, 2, 4])
def test_pipeline_draws_equal_the_jax_key_tree(num_steps):
    shape, idx = (3, 2, 4), [5, 0, 2]
    jkeys = _jax_chain(jax.random.PRNGKey(21), num_steps)
    key = threefry.prng_key(21, "cpu")
    for s, jk in enumerate(jkeys):
        pair = threefry.split(key)
        key, nkey = pair[0], pair[1]
        np.testing.assert_array_equal(nkey.numpy().astype(np.uint32), np.asarray(jk))
        for i in idx:
            fk = threefry.fold_in(nkey, i)
            jfk = jax.random.fold_in(jk, i)
            bits = threefry.random_bits(fk, shape).numpy().astype(np.uint32)
            np.testing.assert_array_equal(bits, np.asarray(jax.random.bits(jfk, shape, jnp.uint32)))
            np.testing.assert_array_equal(threefry.uniform(fk, shape).numpy(),
                                          np.asarray(jax.random.uniform(jfk, shape, jnp.float32)))
    noise = sana.pipeline_noise(threefry.prng_key(21, "cpu"), idx, num_steps, shape)
    assert tuple(noise.shape) == (len(idx), num_steps + 1, *shape)
    for s, jk in enumerate(jkeys):
        j = np.asarray(jsana._per_image_normal(jk, jnp.asarray(idx), len(idx), shape))
        np.testing.assert_allclose(noise[:, s].numpy(), j, rtol=0, atol=1e-6)
    # a batch of keys draws each key's tree
    both = sana.pipeline_noise(torch.stack([threefry.prng_key(21, "cpu"), threefry.prng_key(22, "cpu")]), idx,
                               num_steps, shape)
    assert torch.equal(both[0], noise)
    assert torch.equal(both[1], sana.pipeline_noise(threefry.prng_key(22, "cpu"), idx, num_steps, shape))


@pytest.fixture(scope="module", params=["float", "int8"])
def sana_pair(request):
    jcfg = jsana.SanaConfig(**SANA_KW, compute_dtype=jnp.float32)
    tcfg = sana.SanaConfig(**SANA_KW, compute_dtype=torch.float32)
    params = jsana.init_sana(jax.random.PRNGKey(11), jcfg)
    if request.param == "int8":
        params = jquantize_tree(params, min_size=0)
    spec = jcfg.lora_spec()
    lora = jax.tree_util.tree_map(lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(8), x.shape),
                                  jinit_lora(jax.random.PRNGKey(7), params, spec))
    return dict(jcfg=jcfg, params=params, lora=lora, spec=spec, model=sana_from_jax(_np(params), tcfg, "cpu"),
                tlora=adapter_from_jax(_np(lora), "cpu"))


@pytest.mark.parametrize("num_steps", [1, 2, 3])
def test_multistep_generate_from_a_key_matches_jax(sana_pair, num_steps):
    s = sana_pair
    emb = jax.random.normal(jax.random.PRNGKey(12), (3, 6, 16))
    idx = jnp.array([4, 0, 9])
    j = jsana.multistep_generate(s["params"], s["jcfg"], emb, jnp.ones((3, 6), bool), jax.random.PRNGKey(13),
                                 guidance_scale=1.0, num_steps=num_steps, latent_hw=(4, 4), lora=s["lora"],
                                 lora_scale=s["spec"].scale, item_index=idx)
    with torch.inference_mode():
        out = sana.multistep_generate(s["model"], torch.from_numpy(np.array(emb)), torch.ones(3, 6, dtype=torch.bool),
                                      threefry.prng_key(13, "cpu"), guidance_scale=1.0, num_steps=num_steps,
                                      latent_hw=(4, 4), lora=s["tlora"], lora_scale=s["spec"].scale,
                                      item_index=[4, 0, 9])
    assert out.shape == (3, 4, 4, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), **TOL)


def _pipeline_cfgs(steps=2):
    jmodel = jsana.SanaConfig(**SANA_KW, compute_dtype=jnp.float32)
    jvae = jdcae.DCAEConfig(latent_channels=4, channels=(8, 8), blocks_per_stage=(1, 1), attn_stages=(),
                            compute_dtype=jnp.float32)
    tmodel = sana.SanaConfig(**SANA_KW, compute_dtype=torch.float32)
    tvae = dcae.DCAEConfig(latent_channels=4, channels=(8, 8), blocks_per_stage=(1, 1), attn_stages=(),
                           compute_dtype=torch.float32)
    common = dict(backend_mode="pipeline", num_inference_steps=steps, width_latent=4, height_latent=4, lora_r=2,
                  lora_alpha=4.0)
    return JSanaBackendConfig(model=jmodel, vae=jvae, **common), SanaBackendConfig(model=tmodel, vae=tvae, **common)


def test_generate_p_in_pipeline_mode_matches_jax():
    jcfg, tcfg = _pipeline_cfgs(steps=2)
    jb = JSanaBackend(jcfg)
    jb.setup()
    assert jb.name == "sana_pipeline"
    theta = jax.tree_util.tree_map(lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(31), x.shape),
                                   jb.init_theta(jax.random.PRNGKey(30)))
    ids = jnp.array([0, 0], jnp.int32)
    j = np.asarray(jb.generate_p(jb.frozen, theta, ids, jax.random.PRNGKey(5)))
    tb = SanaBackend(tcfg, "cpu", params=tree_from_numpy(_np(jb.params), "cpu"),
                     vae_params=tree_from_numpy(_np(jb.vae_params), "cpu"), prompts=jb.prompts)
    tb.setup()
    tb.prompt_embeds = torch.from_numpy(np.array(jb.prompt_embeds))
    assert tb.name == "sana_pipeline" and tb.noise_shape == (3, 4, 4, 4)
    stacked = {k: {f: t[None] for f, t in d.items()} for k, d in adapter_from_jax(_np(theta), "cpu").items()}
    with torch.inference_mode():
        out = tb.generate_p(stacked, [[0, 0]], threefry.prng_key(5, "cpu")[None])[0]
    assert out.shape == j.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(out.numpy(), j, **TOL)
    assert np.abs(j[0] - j[1]).max() > 1e-4  # image j of a request folds j in
    # one step of the same backend gives another image
    with torch.inference_mode():
        one = tb.with_mode("one_step").generate_p(stacked, [[0, 0]], threefry.prng_key(5, "cpu")[None])[0]
    assert tb.with_mode("one_step").model is tb.model and float((one - out).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# run_training with the pipeline backend, nothing injected
# ---------------------------------------------------------------------------

PROMPTS = ["a red square", "a blue circle", "a green cat"]
PARITY = dict(num_epochs=2, pop_size=4, sigma=0.05, lr_scale=1.0, egg_rank=2, prompts_per_gen=2, member_batch=2,
              save_every=1, quality=True, seed=3, run_name="parity")


def jax_brightness(images, prompt_ids):
    return {"combined": images.mean(axis=(1, 2, 3)).astype(jnp.float32)}


def brightness(images, prompt_ids):
    return {"combined": images.mean(dim=(1, 2, 3)).to(torch.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline_runs")
    jcfg, tcfg = _pipeline_cfgs(steps=2)
    prompts = root / "prompts.txt"
    prompts.write_text("\n".join(PROMPTS) + "\n")
    jb = JSanaBackend(dataclasses.replace(jcfg, prompts_txt_path=str(prompts)))
    jrun_training(jb, jax_brightness, JTrainConfig(run_dir=str(root / "jax"), **PARITY))
    state = trainer.run_training(SanaBackend(tcfg, "cpu", prompts=PROMPTS), brightness,
                                 TrainConfig(run_dir=str(root / "port"), **PARITY), device="cpu")
    return dict(jdir=root / "jax" / "parity", pdir=root / "port" / "parity", state=state)


def test_run_training_from_a_seed_matches_jax(runs):
    jrows = read_jsonl_rows(runs["jdir"] / "metrics.jsonl")
    prows = read_jsonl_rows(runs["pdir"] / "metrics.jsonl")
    assert len(jrows) == len(prows) == 2
    for j, p in zip(jrows, prows):
        shared = (set(j) & set(p)) - CLOCK_KEYS
        assert len(shared) > 10
        for k in sorted(shared):
            if isinstance(j[k], str) or k == "prompts":
                assert j[k] == p[k], k
            elif not isinstance(j[k], dict):
                np.testing.assert_allclose(np.asarray(p[k], np.float64), np.asarray(j[k], np.float64),
                                           err_msg=k, **TOL)
    slot = "ckpt/step_00000002/theta.npz"
    with np.load(runs["jdir"] / slot) as jz, np.load(runs["pdir"] / slot) as pz:
        assert set(jz.files) == set(pz.files)
        for k in jz.files:
            np.testing.assert_allclose(pz[k], jz[k], err_msg=k, **TOL)
    assert runs["state"].epoch == 2
