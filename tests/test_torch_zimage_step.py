"""Port parity: the Z-Image ES step, tiny, f32.

The JAX package's ``make_es_step`` runs its tiny Z-Image backend (d 24, 2
layers, the decoder at ch (8, 8), latent 4, 2 Euler steps; the dual adapter
with conv LoRA on the decoder; 3 prompts with synthetic ragged embeddings,
2 a step; pop 4, member_batch 2) in three configurations: an int8 base
(``quantize_tree(min_size=512)`` of the transformer and the decoder) with
``pop_fuse`` on and off, and a float base with ``pop_fuse``. Weights,
prompts, adapter, CLIP tower and table are carried over; the JAX ES noise
and the starting latents are injected (``fold_in(k_gen, i)``'s normals).

- θ′ (both adapters), the opt scores, the reward rows and every metric
  within 3e-4 (measured over the three: θ′ ≤ 1.9e-7, rows ≤ 2.1e-7, opt
  scores ≤ 4.1e-6, metrics ≤ 3.2e-6);
- with nothing injected (the port's own draws from the same key), the same
  within 3e-4 (measured within the bounds above);
- under ``pop_fuse`` every adapted block site over the int8 base takes K3's
  wrapper (``fused_qlora_matmul``, 4 sites × 2 layers × 2 steps a call)
  and none the ``dequant_matmul`` composition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.backends.base import make_frozen
from hyperscalees_t2i_tpu.backends.zimage_backend import ZImageBackend as JBackend
from hyperscalees_t2i_tpu.backends.zimage_backend import ZImageBackendConfig as JConfig
from hyperscalees_t2i_tpu.es.noiser import sample_noise as jsample_noise
from hyperscalees_t2i_tpu.models import clip as jclip
from hyperscalees_t2i_tpu.ops import quant as jquant
from hyperscalees_t2i_tpu.rewards import suite as jsuite
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import make_es_step as jmake_es_step
from hyperscalees_t2i_tpu_torch.backends.zimage_backend import ZImageBackend, ZImageBackendConfig
from hyperscalees_t2i_tpu_torch.ops import fused_qlora as tfq
from hyperscalees_t2i_tpu_torch.rewards.suite import make_clip_reward_fn
from hyperscalees_t2i_tpu_torch.rungs import infinity_rung_model
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.train.trainer import make_es_step
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.utils.pytree import tree_leaves
from hyperscalees_t2i_tpu_torch.weights.from_jax import clip_from_jax, tree_from_numpy

from test_torch_var_step import _HostRows, _jax_clip_cfg
from test_torch_zimage import TINY, _np, jcfg, jvcfg, tcfg, tvcfg

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
POP, M, SIGMA, MB = 4, 2, 0.02, 2
PROMPTS = ["a red square", "a blue circle", "a green cat"]
CONFIGS = {"int8_fused": (True, True), "int8": (True, False), "float_fused": (False, True)}


def _jax_gen_noise(k_gen, count):
    """The JAX generator's starting latents of images ``range(count)``."""
    keys = jax.vmap(lambda i: jax.random.fold_in(k_gen, i))(jnp.arange(count))
    return np.array(jax.vmap(lambda k: jax.random.normal(k, (4, 4, TINY["in_channels"]), jnp.float32))(keys))


def _port_backend(jb):
    cfg = ZImageBackendConfig(model=tcfg(), vae=tvcfg(), num_steps=2, width_latent=4, height_latent=4, lora_r=2,
                              lora_alpha=4.0, train_vae_decoder_lora=True)
    b = ZImageBackend(cfg, "cpu", params=tree_from_numpy(_np(jb.params), "cpu"),
                      vae_params=tree_from_numpy(_np(jb.vae_params), "cpu"), prompts=jb.prompts,
                      text=(torch.from_numpy(np.array(jb.prompt_embeds)), torch.from_numpy(np.array(jb.prompt_mask))))
    b.setup()
    return b


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def run(request, tmp_path_factory):
    int8, fuse = CONFIGS[request.param]
    path = tmp_path_factory.mktemp("zimage") / "prompts.txt"
    path.write_text("\n".join(PROMPTS) + "\n")
    jb = JBackend(JConfig(model=jcfg(), vae=jvcfg(), prompts_txt_path=str(path), num_steps=2, width_latent=4,
                          height_latent=4, lora_r=2, lora_alpha=4.0, train_vae_decoder_lora=True))
    jb.setup()
    if int8:
        jb.params = jquant.quantize_tree(jb.params, min_size=512)
        jb.vae_params = jquant.quantize_tree(jb.vae_params, min_size=512)
    ccfg = _jax_clip_cfg()
    cparams = jclip.init_clip(jax.random.PRNGKey(6), ccfg)
    table = jsuite.clip_text_embed_table(
        cparams, ccfg, jax.random.randint(jax.random.PRNGKey(7), (jb.num_items + 2, 8), 0, ccfg.vocab_size))
    theta = jb.init_theta(jax.random.PRNGKey(1))
    theta = jax.tree_util.tree_map(lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(3), x.shape), theta)
    jreward = _HostRows(jsuite.make_clip_reward_fn(cparams, ccfg, table))
    jtc = JTrainConfig(pop_size=POP, sigma=SIGMA, egg_rank=2, prompts_per_gen=M, batches_per_gen=1,
                       member_batch=MB, promptnorm=True, pop_fuse=fuse)
    info = jb.step_info(0, M, 1)
    key = jax.random.PRNGKey(2)
    k_noise, k_gen = jax.random.split(key)
    step = jmake_es_step(jb, jreward, jtc, M, 1, donate=False)
    jtheta, jmetrics, jopt = step(make_frozen(jb, jreward), theta, jnp.asarray(info.flat_ids, jnp.int32), key)
    jax.effects_barrier()
    jrows = {k: np.concatenate([c[k].reshape(-1, M) for c in jreward.calls]) for k in jreward.calls[0]}
    noise = jsample_noise(k_noise, theta, POP, jtc.es_config())

    backend = _port_backend(jb)
    reward = make_clip_reward_fn(clip_from_jax(_np(cparams), infinity_rung_model("tiny")["clip_b"], "cpu"),
                                 torch.from_numpy(np.array(table)))
    calls = []

    def recording_reward(images, ids):
        out = reward(images, ids)
        calls.append(out)
        return out

    tc = TrainConfig(pop_size=POP, sigma=SIGMA, egg_rank=2, member_batch=MB, pop_fuse=fuse)
    counts = {"fused_qlora": 0, "dequant_matmul": 0}
    real_k3, real_dq = tfq.fused_qlora_matmul, tfq.dequant_matmul

    def k3(*a, **kw):
        counts["fused_qlora"] += 1
        return real_k3(*a, **kw)

    def dq(*a, **kw):
        counts["dequant_matmul"] += 1
        return real_dq(*a, **kw)

    step = make_es_step(backend, recording_reward, tc, M, 1, device="cpu")
    ptheta0 = tree_from_numpy(_np(theta), "cpu")
    tfq.fused_qlora_matmul, tfq.dequant_matmul = k3, dq
    try:
        pout = step(ptheta0, info.flat_ids, threefry.prng_key(2, "cpu"), noise=tree_from_numpy(_np(noise), "cpu"),
                    gen_noise=torch.from_numpy(_jax_gen_noise(k_gen, M)))
    finally:
        tfq.fused_qlora_matmul, tfq.dequant_matmul = real_k3, real_dq
    prows = {k: torch.cat([c[k].reshape(-1, M) for c in calls]).numpy() for k in calls[0]}
    calls.clear()
    own = step(ptheta0, info.flat_ids, threefry.prng_key(2, "cpu"))
    own_rows = {k: torch.cat([c[k].reshape(-1, M) for c in calls]).numpy() for k in calls[0]}
    return dict(name=request.param, int8=int8, fuse=fuse, jout=(jtheta, jmetrics, jopt, jrows),
                pout=(*pout, prows), own=(*own, own_rows), counts=counts, backend=backend)


def _close(got, want, **kw) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, **kw, **TOL)
    return float(np.abs(got - want).max()) if got.size else 0.0


def _check(jout, pout):
    jtheta, jmetrics, jopt, jrows = jout
    theta, metrics, opt, rows = pout
    jl = jax.tree_util.tree_leaves(jtheta)
    tl = tree_leaves(theta)
    assert len(jl) == len(tl) and len(jl) > 0
    worst = {"theta": max(_close(t.numpy(), j) for j, t in zip(jl, tl)), "opt_scores": _close(opt.numpy(), jopt)}
    for k in jrows:
        assert rows[k].shape == (POP, M)
    worst["rows"] = max(_close(rows[k], jrows[k]) for k in jrows)
    assert set(metrics) == set(jmetrics)
    worst["metrics"] = max(_close(metrics[k], jmetrics[k], err_msg=k) for k in jmetrics)
    assert float(metrics["delta_norm"]) > 0
    print(f"max abs errors: {worst}")


def test_step_matches_jax(run):
    _check(run["jout"], run["pout"])
    assert set(run["pout"][0]) == {"transformer", "vae_decoder"}
    # the int8 configurations really ran on an int8 base
    assert any(hasattr(m, "q8") for m in run["backend"].model.blocks.modules()) == run["int8"]


def test_step_from_a_seed_matches_jax(run):
    """The port's own draws (ES noise, starting latents) from the same key."""
    _check(run["jout"], run["own"])


def test_fused_sites_take_k3(run):
    calls = -(-POP // MB)
    if run["int8"] and run["fuse"]:
        assert run["counts"] == {"fused_qlora": calls * 4 * TINY["n_layers"] * 2, "dequant_matmul": 0}
    else:
        assert run["counts"]["fused_qlora"] == 0
