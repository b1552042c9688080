"""Port parity: one EGGROLL-ES epoch step at the tiny rung (pop 4, 4
prompts, member_batch 1), f32, against the JAX package.

Four variants: ``pop_fuse`` off and on, over a float base and an int8 base
(``quantize_tree(min_size=0)`` on the DiT, the decoder and both CLIP
towers), so the plain versions of K2 (float base, factored leaves) and K3
(int8 base, factored leaves) both run. Weights, prompt embeddings and text
tables are the JAX package's, carried over; the JAX ES noise and the
per-image generation latents are injected (``noise=``/``gen_noise=``), and,
in ``test_step_with_nothing_injected_matches_jax``, drawn by the port from
the JAX program's key.

The JAX side of each variant is the JAX package's ``make_es_step`` itself
(one compile per variant). Its reward suite hands each call's rewards to
the host through an ordered ``jax.debug.callback``, in the member loop's
order, so the test also reads the ``[pop, B]`` reward rows of that program.

Bound 3e-4 (the golden bound) on θ′, the opt scores, the reward rows and
every metric shared by name; measured max abs error ≤ 1.0e-5. The metric
names agree exactly with ``quality`` off and on: the JAX side of that check
is the JAX ``_combine_and_update`` on the JAX program's own reward rows,
its ES noise and θ, with the same ``quality`` (the ``quality/*`` vectors
within 3e-4 too). Within the port,
``reward_tile`` 0/1 and ``member_batch`` 1/2/4 agree at rtol/atol 1e-5
(measured ≤ 1.4e-5 abs, on opt scores of magnitude ~1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu import rungs as jrungs
from hyperscalees_t2i_tpu.backends.base import make_frozen
from hyperscalees_t2i_tpu.backends.sana_backend import SanaBackend as JBackend
from hyperscalees_t2i_tpu.es.noiser import sample_noise as jsample_noise
from hyperscalees_t2i_tpu.models import clip as jclip
from hyperscalees_t2i_tpu.models import sana as jsana
from hyperscalees_t2i_tpu.ops.quant import quantize_tree as jquantize_tree
from hyperscalees_t2i_tpu.rewards import suite as jsuite
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import _combine_and_update as jcombine_and_update
from hyperscalees_t2i_tpu.train.trainer import make_es_step as jmake_es_step
from hyperscalees_t2i_tpu_torch.backends.sana_backend import SanaBackend, build_train_backend
from hyperscalees_t2i_tpu_torch.rewards.suite import make_clip_reward_fn
from hyperscalees_t2i_tpu_torch.rungs import BENCH_PROMPT_SET, sana_rung_model
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.train.trainer import make_es_step
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.weights.from_jax import (
    adapter_from_jax, clip_from_jax, tree_from_numpy,
)

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
POP, M, LTXT = 4, 4, 32
PROMPTS = jrungs.BENCH_PROMPT_SET[:6]
SIGMA = 0.01


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_side(int8: bool):
    """The tiny rung in f32: JAX backend, reward suite and adapter."""
    spec = jrungs.sana_rung_model("tiny")
    bcfg, ccfg = spec["bcfg"], spec["clip_b"]
    bcfg.model = dataclasses.replace(bcfg.model, compute_dtype=jnp.float32)
    bcfg.vae = dataclasses.replace(bcfg.vae, compute_dtype=jnp.float32)
    backend = JBackend(bcfg)
    backend.setup()
    backend.prompts = list(PROMPTS)
    backend.prompt_embeds = jax.random.normal(jax.random.PRNGKey(5), (len(PROMPTS), LTXT, bcfg.model.caption_dim))
    backend.prompt_mask = jnp.ones((len(PROMPTS), LTXT), bool)
    cparams = jclip.init_clip(jax.random.PRNGKey(6), ccfg)
    pparams = jclip.init_clip(jax.random.PRNGKey(8), ccfg)
    table = jsuite.clip_text_embed_table(
        cparams, ccfg, jax.random.randint(jax.random.PRNGKey(7), (len(PROMPTS) + 2, 8), 0, ccfg.vocab_size))
    ptable = jsuite.pickscore_text_embeds(
        pparams, ccfg, jax.random.randint(jax.random.PRNGKey(9), (len(PROMPTS), 8), 0, ccfg.vocab_size))
    if int8:
        backend.params = jquantize_tree(backend.params, min_size=0)
        backend.vae_params = jquantize_tree(backend.vae_params, min_size=0)
        cparams, pparams = jquantize_tree(cparams, min_size=0), jquantize_tree(pparams, min_size=0)
    reward = jsuite.make_clip_reward_fn(cparams, ccfg, table, pick_params=pparams, pick_cfg=ccfg,
                                        pick_text_embeds=ptable)
    theta = backend.init_theta(jax.random.PRNGKey(1))
    theta = jax.tree_util.tree_map(lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(3), x.shape), theta)
    return backend, reward, theta, (cparams, pparams, table, ptable)


def _port_side(jbackend, towers, device="cpu"):
    cparams, pparams, table, ptable = towers
    spec = sana_rung_model("tiny")
    bcfg = spec["bcfg"]
    bcfg = dataclasses.replace(bcfg, model=dataclasses.replace(bcfg.model, compute_dtype=torch.float32),
                               vae=dataclasses.replace(bcfg.vae, compute_dtype=torch.float32))
    backend = SanaBackend(bcfg, device, params=tree_from_numpy(_np(jbackend.params), device),
                          vae_params=tree_from_numpy(_np(jbackend.vae_params), device), prompts=PROMPTS)
    backend.prompt_embeds = torch.from_numpy(np.array(jbackend.prompt_embeds)).to(device)
    backend.prompt_mask = torch.ones(len(PROMPTS), LTXT, dtype=torch.bool, device=device)
    backend.setup()
    reward = make_clip_reward_fn(
        clip_from_jax(_np(cparams), spec["clip_b"], device), torch.from_numpy(np.array(table)).to(device),
        pick_model=clip_from_jax(_np(pparams), spec["clip_b"], device),
        pick_text_embeds=torch.from_numpy(np.array(ptable)).to(device))
    return backend, reward


class _HostRows:
    """A JAX reward suite whose every call also hands its reward dict to the
    host (ordered callback: the member loop's order)."""

    def __init__(self, suite):
        self.suite, self.frozen, self.calls = suite, suite.frozen, []

    def apply(self, frozen, images, prompt_ids):
        out = self.suite.apply(frozen, images, prompt_ids)
        jax.debug.callback(lambda o: self.calls.append(_np(o)), out, ordered=True)
        return out


@pytest.fixture(scope="module", params=["float-materialized", "float-fused", "int8-materialized", "int8-fused"])
def variant(request):
    base, path = request.param.split("-")
    pop_fuse = path == "fused"
    jb, jsuite_fn, theta, towers = _jax_side(base == "int8")
    jreward = _HostRows(jsuite_fn)
    jtc = JTrainConfig(pop_size=POP, sigma=SIGMA, egg_rank=4, prompts_per_gen=M, batches_per_gen=1,
                       member_batch=1, promptnorm=True, pop_fuse=pop_fuse, quality=False)
    info = jb.step_info(0, M, 1)
    flat = jnp.asarray(info.flat_ids, jnp.int32)
    key = jax.random.PRNGKey(2)
    k_noise, k_gen = jax.random.split(key)
    step = jmake_es_step(jb, jreward, jtc, M, 1, donate=False)
    jtheta, jmetrics, jopt = step(make_frozen(jb, jreward), theta, flat, key)
    jax.effects_barrier()
    assert len(jreward.calls) == POP  # one reward call per member (member_batch 1, untiled)
    jrewards = {k: np.stack([c[k].reshape(M) for c in jreward.calls]) for k in jreward.calls[0]}
    jout = (jtheta, jmetrics, jopt, jrewards)
    noise = jsample_noise(k_noise, theta, POP, jtc.es_config())
    zeros = jax.tree_util.tree_map(jnp.zeros_like, theta)
    jcombine = {q: jcombine_and_update(theta, zeros, noise, {k: jnp.asarray(v) for k, v in jrewards.items()},
                                       tc=dataclasses.replace(jtc, quality=q), es_cfg=jtc.es_config(), pop=POP,
                                       num_unique=M, repeats=1)[2]
                for q in (False, True)}
    gen = np.array(jsana._per_image_normal(k_gen, jnp.arange(M), M, (8, 8, 4)))
    tb, treward = _port_side(jb, towers)
    tc = TrainConfig(pop_size=POP, sigma=SIGMA, egg_rank=4, member_batch=1, pop_fuse=pop_fuse)
    inputs = dict(theta=adapter_from_jax(_np(theta), "cpu"), noise=tree_from_numpy(_np(noise), "cpu"),
                  gen=torch.from_numpy(gen), flat=info.flat_ids)
    return dict(jout=jout, jcombine=_np(jcombine), tb=tb, treward=treward, tc=tc, inputs=inputs)


def _run_port(v, inject=True, **overrides):
    tc = dataclasses.replace(v["tc"], **overrides)
    rows = {}
    reward = v["treward"]

    def recording_reward(images, ids):
        out = reward(images, ids)
        rows.setdefault("tiles", []).append(out)
        return out

    step = make_es_step(v["tb"], recording_reward, tc, M, 1, device="cpu")
    i = v["inputs"]
    draws = dict(noise=i["noise"], gen_noise=i["gen"]) if inject else {}
    theta, metrics, opt = step(i["theta"], i["flat"], threefry.prng_key(2, "cpu"), **draws)
    return theta, metrics, opt, rows["tiles"]


def _rows(tiles, tc):
    """The step's ``[pop, B]`` rows from the reward calls it made (chunks
    of ``member_batch`` lanes, tiles of ``reward_tile`` images)."""
    n, tile = tc.member_batch, tc.reward_tile or M
    per_chunk = M // tile
    out = {}
    for k in tiles[0]:
        chunks = [torch.cat([t[k].reshape(n, -1) for t in tiles[c * per_chunk:(c + 1) * per_chunk]], dim=1)
                  for c in range(POP // n)]
        out[k] = torch.cat(chunks).numpy()
    return out


def test_step_matches_jax(variant):
    _assert_step_matches_jax(variant, _run_port(variant))


def test_step_with_nothing_injected_matches_jax(variant):
    """The port draws the ES noise and the latents from the JAX program's
    key itself."""
    _assert_step_matches_jax(variant, _run_port(variant, inject=False))


def _assert_step_matches_jax(v, port):
    jtheta, jmetrics, jopt, jrewards = v["jout"]
    theta, metrics, opt, tiles = port
    for p in jtheta:
        for f in jtheta[p]:
            np.testing.assert_allclose(theta[p][f].numpy(), np.asarray(jtheta[p][f]), **TOL)
    np.testing.assert_allclose(opt.numpy(), np.asarray(jopt), **TOL)
    rows = _rows(tiles, v["tc"])
    for k in jrewards:
        assert rows[k].shape == (POP, M)
        np.testing.assert_allclose(rows[k], np.asarray(jrewards[k]), **TOL)
    for k in jmetrics:
        np.testing.assert_allclose(np.asarray(metrics[k], np.float64), np.asarray(jmetrics[k], np.float64),
                                   err_msg=k, **TOL)
    assert float(metrics["delta_norm"]) > 0


@pytest.mark.parametrize("quality", [False, True], ids=["quality_off", "quality_on"])
def test_metric_names_match_jax(variant, quality):
    _, metrics, _, _ = _run_port(variant, quality=quality)
    jmetrics = variant["jcombine"][quality]
    assert set(variant["jout"][1]) == set(variant["jcombine"][False])  # the compiled program's names
    assert set(metrics) == set(jmetrics)
    assert any(k.startswith("quality/") for k in metrics) == quality
    assert "es/leaf_delta_norm/blocks/attn1/to_q" in metrics
    for k in jmetrics:
        np.testing.assert_allclose(np.asarray(metrics[k], np.float64), np.asarray(jmetrics[k], np.float64),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("overrides", [dict(reward_tile=1), dict(member_batch=4), dict(member_batch=2, reward_tile=2)])
def test_chunking_and_tiling_leave_the_step_unchanged(variant, overrides):
    base_theta, _, base_opt, base_tiles = _run_port(variant)
    theta, _, opt, tiles = _run_port(variant, **overrides)
    base_rows = _rows(base_tiles, variant["tc"])
    rows = _rows(tiles, dataclasses.replace(variant["tc"], **overrides))
    for k in base_rows:
        np.testing.assert_allclose(rows[k], base_rows[k], rtol=1e-5, atol=1e-5)
    for p in base_theta:
        for f in base_theta[p]:
            np.testing.assert_allclose(theta[p][f].numpy(), base_theta[p][f].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(opt.numpy(), base_opt.numpy(), rtol=1e-5, atol=1e-5)


def test_stateful_step_threads_the_update(variant):
    v = variant
    i = v["inputs"]
    step = make_es_step(v["tb"], v["treward"], v["tc"], M, 1, device="cpu", stateful_delta=True)
    zeros = {p: {f: torch.zeros_like(t) for f, t in d.items()} for p, d in i["theta"].items()}
    theta1, delta1, m1, _ = step(i["theta"], zeros, i["flat"], threefry.prng_key(2, "cpu"), noise=i["noise"],
                                 gen_noise=i["gen"])
    assert float(m1["es/update_cosine"]) == 0.0
    _, _, m2, _ = step(theta1, delta1, i["flat"], threefry.prng_key(2, "cpu"), noise=i["noise"], gen_noise=i["gen"])
    assert -1.0 <= float(m2["es/update_cosine"]) <= 1.0 and float(m2["es/update_cosine"]) != 0.0


@pytest.mark.parametrize("quality", [False, True], ids=["quality_off", "quality_on"])
def test_step_refuses_quality_and_a_missing_card(variant, monkeypatch, quality):
    """The step builds with ``quality`` off or on (it refused ``quality=True``
    until ``obs/quality.py`` was ported) and refuses a missing card."""
    v = variant
    tc = dataclasses.replace(v["tc"], quality=quality)
    assert callable(make_es_step(v["tb"], v["treward"], tc, M, 1, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_es_step(v["tb"], v["treward"], v["tc"], M, 1)
    with pytest.raises(RuntimeError):
        make_es_step(v["tb"], v["treward"], v["tc"], M, 1, device="cuda")


@pytest.mark.parametrize("base_quant", [None, "int8"])
def test_build_train_backend_small_rung_step(base_quant):
    """``build_train_backend`` on the ``small`` rung: the base as
    ``RUNG_OPT`` has it (float) or int8 on the DiT, the decoder and both
    towers; one ES step on it gives finite scores and a non-zero update."""
    backend, reward = build_train_backend("small", device="cpu", base_quant=base_quant, seed=0)
    assert backend.texts == BENCH_PROMPT_SET
    n_q8 = [sum(hasattr(m, "q8") for m in mod.modules())
            for mod in (backend.model, backend.vae, reward.clip_model, reward.pick_model)]
    assert all(n > 0 for n in n_q8) if base_quant else not any(n_q8)
    tc = TrainConfig(pop_size=POP, sigma=SIGMA, egg_rank=4, member_batch=1, pop_fuse=True)
    info = backend.step_info(0, M, 1)
    theta = backend.init_theta(threefry.prng_key(1, "cpu"))
    theta_new, metrics, opt = make_es_step(backend, reward, tc, M, 1, device="cpu")(theta, info.flat_ids,
                                                                                    threefry.prng_key(3, "cpu"))
    assert opt.shape == (POP,) and bool(torch.isfinite(opt).all())
    assert all(bool(torch.isfinite(t).all()) for d in theta_new.values() for t in d.values())
    assert float(metrics["delta_norm"]) > 0
