"""Port parity: one EGGROLL-ES epoch step of the VAR backend, tiny, f32.

The JAX package's ``make_es_step`` itself runs the tiny VAR geometry (pop
4, 4 classes of the 10-class pool, 1 repeat; the float base and f32 noise
store of ``RUNG_OPT["ar_d16"]``, the JAX ``"ar"`` knobs), with member_batch 1 and 2. Weights, adapter,
CLIP tower and text table are the JAX package's, carried over; the JAX ES
noise and JAX's own sampling noise (``jax.random.gumbel`` of
``fold_in(fold_in(k_gen, si), i)``, image ``i`` at scale ``si``) are
injected (``noise=``/``gen_noise=``). The JAX reward suite hands each
call's rewards to the host through an ordered ``jax.debug.callback``, so
the test also reads that program's ``[pop, B]`` reward rows.

Bound 3e-4 (the golden bound) on θ′, the opt scores, the reward rows and
every metric shared by name; measured max abs error ≤ 9.6e-7. The metric
names agree exactly, ``quality/*`` included (on by default on both
sides). Within the port, member_batch 1, 2 and 4 agree at
rtol/atol 1e-5, and the step draws its own Gumbel noise when none is given.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.backends.base import make_frozen
from hyperscalees_t2i_tpu.backends.var_backend import VarBackend as JBackend
from hyperscalees_t2i_tpu.backends.var_backend import VarBackendConfig as JConfig
from hyperscalees_t2i_tpu.es.noiser import sample_noise as jsample_noise
from hyperscalees_t2i_tpu.models import clip as jclip
from hyperscalees_t2i_tpu.rewards import suite as jsuite
from hyperscalees_t2i_tpu.rungs import RUNG_OPT as JRUNG_OPT
from hyperscalees_t2i_tpu.rungs import RUNG_PLAN as JRUNG_PLAN
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import make_es_step as jmake_es_step
from hyperscalees_t2i_tpu_torch.backends.var_backend import VarBackend, build_train_backend
from hyperscalees_t2i_tpu_torch.rewards.suite import make_clip_reward_fn
from hyperscalees_t2i_tpu_torch.rungs import RUNG_OPT, RUNG_PLAN, var_rung_model
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.train.trainer import make_es_step
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.weights.from_jax import adapter_from_jax, clip_from_jax, tree_from_numpy

from test_torch_var import _jax_cfg, jax_gumbel

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
POP, M, SIGMA = 4, 4, 0.01


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_clip_cfg():
    t = jclip.CLIPTowerConfig(16, 2, 2, 32)
    return jclip.CLIPConfig(vision=t, text=t, image_size=32, patch_size=16, vocab_size=49408, max_positions=77,
                            projection_dim=16)


class _HostRows:
    """A JAX reward suite whose every call also hands its reward dict to the
    host (ordered callback: the member loop's order)."""

    def __init__(self, suite):
        self.suite, self.frozen, self.calls = suite, suite.frozen, []

    def apply(self, frozen, images, prompt_ids):
        out = self.suite.apply(frozen, images, prompt_ids)
        jax.debug.callback(lambda o: self.calls.append(_np(o)), out, ordered=True)
        return out


@pytest.fixture(scope="module")
def jax_parts():
    cfg = _jax_cfg()
    jb = JBackend(JConfig(model=cfg))
    jb.setup()
    jb.params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(a.size), a.shape) if a.ndim == 1 else a, jb.params)
    ccfg = _jax_clip_cfg()
    cparams = jclip.init_clip(jax.random.PRNGKey(6), ccfg)
    table = jsuite.clip_text_embed_table(
        cparams, ccfg, jax.random.randint(jax.random.PRNGKey(7), (jb.num_items + 2, 8), 0, ccfg.vocab_size))
    theta = jb.init_theta(jax.random.PRNGKey(1))
    theta = jax.tree_util.tree_map(lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(3), x.shape), theta)
    return dict(jb=jb, ccfg=ccfg, cparams=cparams, table=table, theta=theta)


@pytest.fixture(scope="module")
def port_parts(jax_parts):
    p = jax_parts
    backend = VarBackend(var_rung_model("tiny")["bcfg"], "cpu", params=tree_from_numpy(_np(p["jb"].params), "cpu"))
    backend.setup()
    reward = make_clip_reward_fn(clip_from_jax(_np(p["cparams"]), var_rung_model("tiny")["clip_b"], "cpu"),
                                 torch.from_numpy(np.array(p["table"])))
    return backend, reward


@pytest.fixture(scope="module", params=[1, 2], ids=["member_batch_1", "member_batch_2"])
def variant(request, jax_parts, port_parts):
    p, mb = jax_parts, request.param
    jb = p["jb"]
    jreward = _HostRows(jsuite.make_clip_reward_fn(p["cparams"], p["ccfg"], p["table"]))
    jtc = JTrainConfig(pop_size=POP, sigma=SIGMA, egg_rank=4, prompts_per_gen=M, batches_per_gen=1,
                       member_batch=mb, promptnorm=True)
    info = jb.step_info(0, M, 1)
    key = jax.random.PRNGKey(2)
    k_noise, k_gen = jax.random.split(key)
    step = jmake_es_step(jb, jreward, jtc, M, 1, donate=False)
    jtheta, jmetrics, jopt = step(make_frozen(jb, jreward), p["theta"], jnp.asarray(info.flat_ids, jnp.int32), key)
    jax.effects_barrier()
    jrows = {k: np.concatenate([c[k].reshape(-1, M) for c in jreward.calls]) for k in jreward.calls[0]}
    assert jrows["combined"].shape == (POP, M)
    noise = jsample_noise(k_noise, p["theta"], POP, jtc.es_config())
    tc = TrainConfig(pop_size=POP, sigma=SIGMA, egg_rank=4, member_batch=mb)
    inputs = dict(theta=adapter_from_jax(_np(p["theta"]), "cpu"), noise=tree_from_numpy(_np(noise), "cpu"),
                  gen=torch.from_numpy(jax_gumbel(k_gen, jb.cfg.model, M)), flat=info.flat_ids)
    return dict(jout=(jtheta, jmetrics, jopt, jrows), port=port_parts, tc=tc, inputs=inputs)


def _run_port(v, inject=True, **overrides):
    backend, reward = v["port"]
    tc = dataclasses.replace(v["tc"], **overrides)
    calls = []

    def recording_reward(images, ids):
        out = reward(images, ids)
        calls.append(out)
        return out

    i = v["inputs"]
    draws = dict(noise=i["noise"], gen_noise=i["gen"]) if inject else {}
    theta, metrics, opt = make_es_step(backend, recording_reward, tc, M, 1, device="cpu")(
        i["theta"], i["flat"], threefry.prng_key(2, "cpu"), **draws)
    rows = {k: torch.cat([c[k].reshape(-1, M) for c in calls]).numpy() for k in calls[0]}
    return theta, metrics, opt, rows


def test_var_step_matches_jax(variant):
    _assert_step_matches_jax(variant, _run_port(variant))


def test_var_step_with_nothing_injected_matches_jax(variant):
    """The port draws the ES noise and every image's per-scale Gumbel noise
    from the JAX program's key itself."""
    _assert_step_matches_jax(variant, _run_port(variant, inject=False))


def _assert_step_matches_jax(variant, port):
    jtheta, jmetrics, jopt, jrows = variant["jout"]
    theta, metrics, opt, rows = port
    for p in jtheta:
        for f in jtheta[p]:
            np.testing.assert_allclose(theta[p][f].numpy(), np.asarray(jtheta[p][f]), **TOL)
    np.testing.assert_allclose(opt.numpy(), np.asarray(jopt), **TOL)
    for k in jrows:
        assert rows[k].shape == (POP, M)
        np.testing.assert_allclose(rows[k], jrows[k], **TOL)
    for k in jmetrics:
        np.testing.assert_allclose(np.asarray(metrics[k], np.float64), np.asarray(jmetrics[k], np.float64),
                                   err_msg=k, **TOL)
    assert set(metrics) == set(jmetrics)
    assert float(metrics["delta_norm"]) > 0


@pytest.mark.parametrize("member_batch", [1, 2, 4])
def test_member_batch_leaves_the_var_step_unchanged(variant, member_batch):
    base_theta, _, base_opt, base_rows = _run_port(variant)
    theta, _, opt, rows = _run_port(variant, member_batch=member_batch)
    for k in base_rows:
        np.testing.assert_allclose(rows[k], base_rows[k], rtol=1e-5, atol=1e-5)
    for p in base_theta:
        for f in base_theta[p]:
            np.testing.assert_allclose(theta[p][f].numpy(), base_theta[p][f].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(opt.numpy(), base_opt.numpy(), rtol=1e-5, atol=1e-5)


def test_step_draws_gumbel_noise_and_is_seeded(port_parts):
    backend, reward = port_parts
    noise = backend.sample_gen_noise(threefry.prng_key(0, "cpu"), range(32))
    assert noise.shape == (32, *backend.noise_shape) and bool(torch.isfinite(noise).all())
    # standard Gumbel: mean ≈ Euler-Mascheroni 0.5772, var ≈ π²/6 (43008
    # draws: the mean's standard error is 0.0062, the bound 0.02 is 3.2 of them)
    assert abs(float(noise.mean()) - 0.5772) < 0.02 and abs(float(noise.var()) - 1.6449) < 0.05
    tc = TrainConfig(pop_size=POP, sigma=0.1, egg_rank=4, member_batch=2)
    g = torch.Generator().manual_seed(1)
    theta = {k: {f: t + 0.1 * torch.randn(t.shape, generator=g) for f, t in d.items()}
             for k, d in backend.init_theta(threefry.prng_key(1, "cpu")).items()}
    flat = backend.step_info(0, M, 1).flat_ids
    step = make_es_step(backend, reward, tc, M, 1, device="cpu")
    a, b = step(theta, flat, threefry.prng_key(3, "cpu")), step(theta, flat, threefry.prng_key(3, "cpu"))
    torch.testing.assert_close(a[2], b[2])
    assert bool(torch.isfinite(a[2]).all()) and float(a[1]["delta_norm"]) > 0


def test_build_train_backend_tiny_and_the_ar_rung():
    # the JAX package's "ar" plan and knobs, at VAR-d16's geometry under a key of its own
    assert "ar" not in RUNG_PLAN and "ar" not in RUNG_OPT
    assert RUNG_PLAN["ar_d16"] == ("d16", *JRUNG_PLAN["ar"][1:]) == ("d16", 16, 4, 4)
    assert RUNG_OPT["ar_d16"] == {k: JRUNG_OPT["ar"][k] for k in RUNG_OPT["ar_d16"]}
    assert not RUNG_OPT["ar_d16"]["pop_fuse"] and RUNG_OPT["ar_d16"]["base_quant"] == "off"
    backend, reward = build_train_backend("tiny", device="cpu", seed=0)
    assert backend.num_items == 10 and reward.pick_model is None
    assert not any(hasattr(m, "q8") for m in backend.model.modules())
    spec = var_rung_model("d16")
    m = spec["bcfg"].model
    assert (m.depth, m.d_model, m.n_heads, m.seq_len, m.vq.vocab_size) == (16, 1024, 16, 680, 4096)
    assert spec["bcfg"].class_pool == tuple(range(16)) and spec["clip_h"] is not None


def test_var_entry_points_default_to_the_card(monkeypatch):
    """Without a CUDA device the VAR entry points raise unless the CPU is
    named: the backend and `build_train_backend`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VarBackend(var_rung_model("tiny")["bcfg"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_backend("tiny")
    with pytest.raises(RuntimeError):
        VarBackend(var_rung_model("tiny")["bcfg"], "cuda")


def test_run_training_from_a_seed_matches_jax(tmp_path):
    """Nothing injected: the JAX ``run_training`` and the port's, each on the
    tiny VAR backend it builds from ``seed_params``, from the same seed:
    every shared ``metrics.jsonl`` value and the epoch-2 slot's θ within
    3e-4."""
    from hyperscalees_t2i_tpu.train.trainer import run_training as jrun_training
    from hyperscalees_t2i_tpu_torch.train import trainer
    from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows

    from test_torch_trainer import _assert_rows_match, brightness, jax_brightness

    kw = dict(num_epochs=2, pop_size=POP, sigma=0.05, egg_rank=2, prompts_per_gen=2, member_batch=2, save_every=1,
              quality=True, seed=3, run_name="seed")
    jb = JBackend(JConfig(model=_jax_cfg()))
    jb.setup()
    jrun_training(jb, jax_brightness, JTrainConfig(run_dir=str(tmp_path / "jax"), **kw))
    trainer.run_training(VarBackend(var_rung_model("tiny")["bcfg"], "cpu"), brightness,
                         TrainConfig(run_dir=str(tmp_path / "port"), **kw), device="cpu")
    jdir, pdir = tmp_path / "jax" / "seed", tmp_path / "port" / "seed"
    _assert_rows_match(read_jsonl_rows(jdir / "metrics.jsonl"), read_jsonl_rows(pdir / "metrics.jsonl"))
    slot = "ckpt/step_00000002/theta.npz"
    with np.load(jdir / slot) as jz, np.load(pdir / slot) as pz:
        assert set(jz.files) == set(pz.files)
        for k in jz.files:
            np.testing.assert_allclose(pz[k], jz[k], err_msg=k, **TOL)
