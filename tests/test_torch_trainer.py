"""The port's training loop (``train.trainer.run_training``) and the modules
around it, against the JAX package on the CPU.

- End to end: the JAX ``run_training`` (2 epochs, ``save_every=1``,
  ``quality=True``) and the port's on the same tiny Sana backend (the
  geometry of ``tests/test_trainer.py``; weights and prompt embeddings
  carried across) with a brightness reward written once per framework. The
  port gets the JAX θ₀ and each epoch's JAX draws through its two seams
  (``_init_theta``, ``es_draws``). Every shared ``metrics.jsonl`` key
  (``quality/*`` included; wall-clock keys aside), the final θ and the
  epoch-2 slot's θ agree within 3e-4; measured max abs error 1.5e-5 over the
  rows' values, 8.6e-7 on θ. The same holds with nothing injected: the
  port's own run from the seed (weights, prompt embeddings, θ₀ and draws
  from the JAX key tree) against the same JAX run.
- Checkpoint slots cross both ways bitwise (θ and Δθ), with equal manifests
  apart from ``wall_time`` and equal ``slot_theta_digest``; a torn newest
  slot falls back; a topology mismatch raises.
- Port-only counterparts of ``tests/test_trainer.py`` and the loop's
  resilience: ES improves a brightness reward, the promptnorm path, resume,
  a NaN member, SIGTERM, rollback and halt, an interrupted run resumed
  bitwise equal to an uninterrupted one, unported settings refused.
- The host-side pieces against the JAX functions on the same inputs:
  ``quality_metrics`` (1e-6), ``QualityLedger``, ``DegeneracyWatchdog``,
  ``RollbackController``, ``TrainConfig``, the hash tokenizer, the flat
  tree views, ``parse_int_list``, the registry and the tracer's lines.
"""

import dataclasses
import json
import math
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.backends.sana_backend import SanaBackend as JSanaBackend
from hyperscalees_t2i_tpu.backends.sana_backend import SanaBackendConfig as JSanaBackendConfig
from hyperscalees_t2i_tpu.es.noiser import sample_noise as jsample_noise
from hyperscalees_t2i_tpu.es.sampling import epoch_key as jepoch_key
from hyperscalees_t2i_tpu.es.sampling import parse_int_list as jparse_int_list
from hyperscalees_t2i_tpu.models import dcae as jdcae
from hyperscalees_t2i_tpu.models import sana as jsana
from hyperscalees_t2i_tpu.obs.es_health import DegeneracyWatchdog as JWatchdog
from hyperscalees_t2i_tpu.obs.metrics import MetricsRegistry as JRegistry
from hyperscalees_t2i_tpu.obs.quality import QualityLedger as JQualityLedger
from hyperscalees_t2i_tpu.obs.quality import quality_metrics as jquality_metrics
from hyperscalees_t2i_tpu.obs.trace import load_events as jload_events
from hyperscalees_t2i_tpu.resilience.checkpoints import CheckpointStore as JStore
from hyperscalees_t2i_tpu.resilience.checkpoints import slot_theta_digest as jslot_theta_digest
from hyperscalees_t2i_tpu.resilience.rollback import RollbackController as JRollback
from hyperscalees_t2i_tpu.rewards.suite import tokenize_with_hf as jtokenize
from hyperscalees_t2i_tpu.train import checkpoints as jckpt
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import run_training as jrun_training
from hyperscalees_t2i_tpu.utils import pytree as jpytree
from hyperscalees_t2i_tpu_torch.backends.sana_backend import SanaBackend, SanaBackendConfig
from hyperscalees_t2i_tpu_torch.es.sampling import epoch_key, parse_int_list
from hyperscalees_t2i_tpu_torch.models import dcae, sana
from hyperscalees_t2i_tpu_torch.obs.es_health import DegeneracyWatchdog
from hyperscalees_t2i_tpu_torch.obs.metrics import MetricsRegistry
from hyperscalees_t2i_tpu_torch.obs.quality import QualityLedger, quality_metrics
from hyperscalees_t2i_tpu_torch.obs.trace import Tracer
from hyperscalees_t2i_tpu_torch.resilience.checkpoints import CheckpointStore, TopologyMismatch, slot_theta_digest
from hyperscalees_t2i_tpu_torch.resilience.preempt import PreemptionHandler
from hyperscalees_t2i_tpu_torch.resilience.retry import call_with_retry
from hyperscalees_t2i_tpu_torch.resilience.rollback import RollbackController
from hyperscalees_t2i_tpu_torch.rewards.suite import tokenize_with_hf
from hyperscalees_t2i_tpu_torch.train import checkpoints as ckpt
from hyperscalees_t2i_tpu_torch.train import trainer
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.utils import pytree
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows
from hyperscalees_t2i_tpu_torch.weights.from_jax import adapter_from_jax, tree_from_numpy

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
PROMPTS = ["a red square", "a blue circle", "a green cat"]
# keys whose values are wall-clock readings, and the JAX process's count of
# jit cache entries (the port's gauge counts its own programs)
CLOCK_KEYS = {"ts", "step_time_s", "images_per_sec", "obs/compile_cache_entries"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_backend(tmp_path):
    """``tests/test_trainer.py``'s tiny Sana backend."""
    model = jsana.SanaConfig(in_channels=4, out_channels=4, patch_size=1, d_model=24, n_layers=2, n_heads=4,
                             cross_n_heads=4, caption_dim=12, ff_ratio=2.0, compute_dtype=jnp.float32)
    vae = jdcae.DCAEConfig(latent_channels=4, channels=(8, 8), blocks_per_stage=(1, 1), attn_stages=(),
                           compute_dtype=jnp.float32)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("\n".join(PROMPTS) + "\n")
    cfg = JSanaBackendConfig(model=model, vae=vae, prompts_txt_path=str(prompts), width_latent=4, height_latent=4,
                             lora_r=2, lora_alpha=4.0)
    return JSanaBackend(cfg)


def _port_cfg():
    model = sana.SanaConfig(in_channels=4, out_channels=4, patch_size=1, d_model=24, n_layers=2, n_heads=4,
                            cross_n_heads=4, caption_dim=12, ff_ratio=2.0, compute_dtype=torch.float32)
    vae = dcae.DCAEConfig(latent_channels=4, channels=(8, 8), blocks_per_stage=(1, 1), attn_stages=(),
                          compute_dtype=torch.float32)
    return SanaBackendConfig(model=model, vae=vae, width_latent=4, height_latent=4, lora_r=2, lora_alpha=4.0)


def port_backend(jb=None):
    """The same tiny backend in the port: the JAX backend's weights and
    prompt embeddings carried across, or the port's own random ones."""
    if jb is None:
        return SanaBackend(_port_cfg(), "cpu", prompts=PROMPTS)
    b = SanaBackend(_port_cfg(), "cpu", params=tree_from_numpy(_np(jb.params), "cpu"),
                    vae_params=tree_from_numpy(_np(jb.vae_params), "cpu"), prompts=jb.prompts)
    b.prompt_embeds = torch.from_numpy(np.array(jb.prompt_embeds))
    b.prompt_mask = torch.ones(len(jb.prompts), b.prompt_embeds.shape[1], dtype=torch.bool)
    return b


def jax_brightness(images, prompt_ids):
    return {"combined": images.mean(axis=(1, 2, 3)).astype(jnp.float32)}


def brightness(images, prompt_ids):
    return {"combined": images.mean(dim=(1, 2, 3)).to(torch.float32)}


def _flat(theta):
    return torch.cat([t.reshape(-1) for t in pytree.tree_leaves(theta)])


# ---------------------------------------------------------------------------
# end to end against the JAX run_training
# ---------------------------------------------------------------------------

PARITY = dict(num_epochs=2, pop_size=4, sigma=0.05, lr_scale=1.0, egg_rank=2, prompts_per_gen=2,
              member_batch=2, save_every=1, quality=True, seed=3, run_name="parity")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX ``run_training`` (its only compile in this file), its θ₀ and
    each epoch's draws: ``epoch_key(seed, e)`` split into the ES-noise key
    and the generation key, as its ``make_es_step`` splits it."""
    root = tmp_path_factory.mktemp("jax_run")
    jb = _jax_backend(root)
    jtc = JTrainConfig(run_dir=str(root / "runs"), **PARITY)
    jrun_training(jb, jax_brightness, jtc)
    theta0 = jb.init_theta(jax.random.fold_in(jax.random.PRNGKey(jtc.seed), 17))
    draws = {}
    for e in range(jtc.num_epochs):
        k_noise, k_gen = jax.random.split(jepoch_key(jtc.seed, e))
        B = len(jb.step_info(e, jtc.prompts_per_gen, jtc.batches_per_gen).flat_ids)
        draws[e] = (_np(jsample_noise(k_noise, theta0, jtc.pop_size, jtc.es_config())),
                    np.asarray(jsana._per_image_normal(k_gen, jnp.arange(B), B, (4, 4, 4))))
    run_dir = root / "runs" / "parity"
    return dict(jb=jb, theta0=_np(theta0), draws=draws, rows=read_jsonl_rows(run_dir / "metrics.jsonl"),
                run_dir=run_dir)


def _epoch_of(key, seed):
    """The epoch whose ``epoch_key(seed, epoch)`` is ``key`` (the step draws
    from its key inside its program; the tests' draws are by epoch)."""
    return next(e for e in range(64) if torch.equal(epoch_key(seed, e, "cpu"), key.cpu()))


def _with_jax_draws(monkeypatch, theta0, draws, seed=PARITY["seed"]):
    monkeypatch.setattr(trainer, "_init_theta", lambda backend, tc, dev: adapter_from_jax(theta0, dev))

    def jax_draws(backend, theta, key, pop, es_cfg, count, noise=None, gen_noise=None):
        e = _epoch_of(key, seed)
        return (tree_from_numpy(draws[e][0], key.device), torch.from_numpy(np.array(draws[e][1])).to(key.device))

    monkeypatch.setattr(trainer, "es_draws", jax_draws)


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    root = tmp_path_factory.mktemp("port_run")
    with pytest.MonkeyPatch.context() as mp:
        _with_jax_draws(mp, jax_run["theta0"], jax_run["draws"])
        state = trainer.run_training(port_backend(jax_run["jb"]), brightness,
                                     TrainConfig(run_dir=str(root / "runs"), **PARITY), device="cpu")
    run_dir = root / "runs" / "parity"
    return dict(state=state, rows=read_jsonl_rows(run_dir / "metrics.jsonl"), run_dir=run_dir)


@pytest.fixture(scope="module")
def seed_run(tmp_path_factory):
    """The port's ``run_training`` from the seed alone: its own weights,
    prompt embeddings, θ₀ and draws, nothing injected."""
    root = tmp_path_factory.mktemp("seed_run")
    state = trainer.run_training(port_backend(), brightness, TrainConfig(run_dir=str(root / "runs"), **PARITY),
                                 device="cpu")
    run_dir = root / "runs" / "parity"
    return dict(state=state, rows=read_jsonl_rows(run_dir / "metrics.jsonl"), run_dir=run_dir)


def test_run_training_rows_match_jax(jax_run, port_run):
    _assert_rows_match(jax_run["rows"], port_run["rows"])


def test_run_training_from_a_seed_matches_jax(jax_run, seed_run):
    """Nothing injected: the same seed gives the JAX run (weights, prompt
    embeddings, θ₀, ES noise and latents all drawn by the port)."""
    _assert_rows_match(jax_run["rows"], seed_run["rows"])
    slot = "ckpt/step_00000002/theta.npz"
    with np.load(jax_run["run_dir"] / slot) as jz, np.load(seed_run["run_dir"] / slot) as pz:
        assert set(jz.files) == set(pz.files)
        for k in jz.files:
            np.testing.assert_allclose(pz[k], jz[k], err_msg=k, **TOL)


def _assert_rows_match(jrows, prows):
    assert [r["epoch"] for r in jrows] == [r["epoch"] for r in prows] == [0, 1]
    worst = 0.0
    for jr, pr in zip(jrows, prows):
        # every key the port writes is one the JAX loop writes
        assert set(pr) - set(jr) == set(), sorted(set(pr) - set(jr))
        shared = sorted(k for k in set(jr) & set(pr) if k not in CLOCK_KEYS and not isinstance(jr[k], dict))
        assert {"quality/combined/prompt_mean", "quality/combined/sigma_share", "es/update_cosine",
                "theta_norm", "reward/combined_mean", "quality/hardest_prompt_mean"} <= set(shared)
        assert pr["prompts"] == jr["prompts"]
        for k in shared:
            if k == "prompts":
                continue
            a, b = np.asarray(pr[k], np.float64), np.asarray(jr[k], np.float64)
            np.testing.assert_allclose(a, b, err_msg=k, **TOL)
            worst = max(worst, float(np.abs(a - b).max()) if a.size else 0.0)
    print(f"max abs error over the shared keys: {worst:.3g}")
    assert worst < 3e-4


def test_run_training_theta_and_slot_match_jax(jax_run, port_run):
    slot = "ckpt/step_00000002/theta.npz"
    with np.load(jax_run["run_dir"] / slot) as jz, np.load(port_run["run_dir"] / slot) as pz:
        assert set(jz.files) == set(pz.files)
        for k in jz.files:
            assert pz[k].dtype == jz[k].dtype == np.float32
            np.testing.assert_allclose(pz[k], jz[k], err_msg=k, **TOL)
            np.testing.assert_array_equal(pz[k], pytree.flatten_with_paths(port_run["state"].theta)[k])
    assert port_run["state"].epoch == 2
    jmanifest = json.loads((jax_run["run_dir"] / "ckpt/step_00000002/manifest.json").read_text())
    pmanifest = json.loads((port_run["run_dir"] / "ckpt/step_00000002/manifest.json").read_text())
    assert set(pmanifest) == set(jmanifest)
    assert pmanifest["topology"] == jmanifest["topology"]
    assert set(pmanifest["config"]) == set(jmanifest["config"])
    assert {k: v for k, v in pmanifest["config"].items() if k != "run_dir"} == \
        {k: v for k, v in jmanifest["config"].items() if k != "run_dir"}


def test_run_training_quality_ledger_matches_jax(jax_run, port_run):
    jrows = read_jsonl_rows(jax_run["run_dir"] / "quality.jsonl")
    prows = read_jsonl_rows(port_run["run_dir"] / "quality.jsonl")
    assert len(prows) == len(jrows) == 2
    for jr, pr in zip(jrows, prows):
        assert set(pr) == set(jr)
        assert [h["idx"] for h in pr["hardest"]] == [h["idx"] for h in jr["hardest"]]
        for k in ("quality/combined/prompt_mean", "quality/combined/prompt_best", "images_cum"):
            np.testing.assert_allclose(pr[k], jr[k], **TOL)


# ---------------------------------------------------------------------------
# checkpoint slots, both ways
# ---------------------------------------------------------------------------

def _theta_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"blocks/attn1/to_q": {"a": rng.standard_normal((2, 6, 2)).astype(np.float32),
                                  "b": rng.standard_normal((2, 2, 6)).astype(np.float32)},
            "proj_out": {"a": rng.standard_normal((6, 2)).astype(np.float32),
                         "b": rng.standard_normal((2, 4)).astype(np.float32)}}


SLOT_ARGS = dict(summary_reward=0.25, backend_name="sana_one_step",
                 config={"sigma": 0.01, "reward_weights": [0.3, 0.3, 0.2, 0.2], "_rollbacks": 0},
                 topology={"process_count": 1, "pop_shards": 1, "pop_size": 4, "pop_host_shard": False})


def _same_tree(torch_tree, np_tree):
    for (pk, pv), (jk, jv) in zip(pytree.flatten_with_paths(torch_tree).items(),
                                  jpytree_flat(np_tree).items()):
        assert pk == jk
        np.testing.assert_array_equal(pv, jv)
        assert pv.dtype == jv.dtype


def jpytree_flat(np_tree):
    from hyperscalees_t2i_tpu.resilience.checkpoints import flatten_with_paths

    return flatten_with_paths(np_tree)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_slot_restores_in_the_other_package_bitwise(tmp_path, writer):
    theta, delta = _theta_np(1), _theta_np(2)
    ttheta, tdelta = tree_from_numpy(theta, "cpu"), tree_from_numpy(delta, "cpu")
    JStore(tmp_path / "j").save(theta, 5, prev_delta=delta, **SLOT_ARGS)
    CheckpointStore(tmp_path / "p").save(ttheta, 5, prev_delta=tdelta, **SLOT_ARGS)
    jm = json.loads((tmp_path / "j/ckpt/step_00000005/manifest.json").read_text())
    pm = json.loads((tmp_path / "p/ckpt/step_00000005/manifest.json").read_text())
    assert {k: v for k, v in pm.items() if k != "wall_time"} == {k: v for k, v in jm.items() if k != "wall_time"}
    assert slot_theta_digest(pm) == jslot_theta_digest(jm) == jslot_theta_digest(pm)
    assert (tmp_path / "p/ckpt/latest").read_text() == (tmp_path / "j/ckpt/latest").read_text()
    src = tmp_path / ("j" if writer == "jax" else "p")
    template = tree_from_numpy(_theta_np(9), "cpu")
    if writer == "jax":
        res = CheckpointStore(src).restore(template, with_delta=True, expect_topology=SLOT_ARGS["topology"])
        _same_tree(res.theta, theta)
        _same_tree(res.prev_delta, delta)
        assert CheckpointStore(src).verify_slot(5, template) == jslot_theta_digest(jm)
    else:
        res = JStore(src).restore(_theta_np(9), with_delta=True, expect_topology=SLOT_ARGS["topology"])
        _same_tree(tree_from_numpy(_np(res.theta), "cpu"), theta)
        _same_tree(tree_from_numpy(_np(res.prev_delta), "cpu"), delta)
        assert JStore(src).verify_slot(5, _theta_np(9)) == slot_theta_digest(pm)
    assert res.epoch == 5 and res.slot == "step_00000005"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_legacy_mirror_crosses_both_ways(tmp_path, writer):
    theta = _theta_np(3)
    if writer == "jax":
        jckpt.write_legacy_mirror(tmp_path, theta, 7, summary_reward=0.5, backend_name="sana")
        theta_r, epoch = ckpt.load_legacy_checkpoint(tmp_path, tree_from_numpy(_theta_np(0), "cpu"))
        _same_tree(theta_r, theta)
    else:
        ckpt.write_legacy_mirror(tmp_path, tree_from_numpy(theta, "cpu"), 7, summary_reward=0.5, backend_name="sana")
        theta_r, epoch = jckpt.load_legacy_checkpoint(tmp_path, _theta_np(0))
        _same_tree(tree_from_numpy(_np(theta_r), "cpu"), theta)
    assert epoch == 7


def test_torn_newest_slot_falls_back_to_the_older(tmp_path):
    reg = MetricsRegistry(prefix="resilience/")
    store = CheckpointStore(tmp_path, keep=3, registry=reg)
    for e in (1, 2):
        store.save(tree_from_numpy(_theta_np(e), "cpu"), e, **SLOT_ARGS)
    p = tmp_path / "ckpt/step_00000002/theta.npz"
    p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])
    template = tree_from_numpy(_theta_np(0), "cpu")
    res = store.restore(template)
    assert res.epoch == 1 and reg.snapshot()["resilience/restore_rejected"] == 1
    _same_tree(res.theta, _theta_np(1))
    assert JStore(tmp_path).restore(_theta_np(0)).epoch == 1  # the JAX package reads it the same way
    # a checksum mismatch in the newer slot falls back the same way
    store.save(tree_from_numpy(_theta_np(3), "cpu"), 3, **SLOT_ARGS)
    m = tmp_path / "ckpt/step_00000003/manifest.json"
    doc = json.loads(m.read_text())
    doc["arrays"]["proj_out/a"]["sha256"] = "0" * 64
    m.write_text(json.dumps(doc))
    assert store.restore(template).epoch == 1 and reg.snapshot()["resilience/restore_rejected"] == 3
    with pytest.raises(ValueError, match="checksum"):
        store.verify_slot(3, template)


def test_topology_mismatch_raises(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(tree_from_numpy(_theta_np(1), "cpu"), 4, **SLOT_ARGS)
    template = tree_from_numpy(_theta_np(0), "cpu")
    with pytest.raises(TopologyMismatch, match="pop_size=4"):
        store.restore(template, expect_topology={"process_count": 1, "pop_size": 8})
    assert store.restore(template, expect_topology={"process_count": 1, "pop_size": 4}).epoch == 4
    assert store.latest_epoch() == 4
    theta, epoch = ckpt.load_checkpoint(tmp_path, template)
    assert epoch == 4
    _same_tree(theta, _theta_np(1))


def test_retention_keeps_the_newest_slots(tmp_path):
    store = CheckpointStore(tmp_path, keep=2)
    for e in range(1, 5):
        store.save(tree_from_numpy(_theta_np(e), "cpu"), e)
    assert [p.name for p in store.slots()] == ["step_00000003", "step_00000004"]
    assert json.loads((tmp_path / "ckpt/step_00000004/manifest.json").read_text())["topology"] == \
        {"process_count": 1}


# ---------------------------------------------------------------------------
# port-only counterparts of tests/test_trainer.py, and the loop's resilience
# ---------------------------------------------------------------------------

def _tc(tmp_path, **kw):
    base = dict(num_epochs=3, pop_size=4, sigma=0.05, lr_scale=1.0, egg_rank=2, prompts_per_gen=2, member_batch=4,
                run_dir=str(tmp_path / "runs"), save_every=1, run_name="r", seed=5)
    return TrainConfig(**{**base, **kw})


def _run(tc, reward=brightness, **kw):
    history = []
    state = trainer.run_training(port_backend(), reward, tc, on_epoch_end=lambda e, s: history.append(s),
                                 device="cpu", **kw)
    return state, history


def test_es_improves_synthetic_reward(tmp_path):
    state, history = _run(_tc(tmp_path, num_epochs=10, pop_size=8, lr_scale=2.0, promptnorm=False, member_batch=8,
                              save_every=0, seed=3))
    assert len(history) == 10 and state.epoch == 10
    first, last = history[0]["reward/combined_mean"], history[-1]["reward/combined_mean"]
    assert np.isfinite(first) and np.isfinite(last) and last > first, (first, last)
    assert not (tmp_path / "runs/r/ckpt").exists()


def test_promptnorm_path_runs(tmp_path):
    state, history = _run(_tc(tmp_path, pop_size=5, egg_rank=1, prompts_per_gen=3, batches_per_gen=2,
                              member_batch=2, save_every=0))
    assert len(history) == 3
    assert all(np.isfinite(h["opt_score_mean"]) for h in history)
    assert len(history[0]["per_prompt_mean"]) == 3 == len(history[0]["quality/combined/prompt_mean"])
    assert history[0]["images_scored"] == 5 * 3 * 2


def test_training_resume_continues(tmp_path):
    _run(_tc(tmp_path, num_epochs=4, save_every=2))
    state, history = _run(_tc(tmp_path, num_epochs=6, save_every=2))
    assert [h["epoch"] for h in history] == [4, 5]
    assert all(h["incarnation"] == 4 for h in history)
    assert state.epoch == 6
    rows = read_jsonl_rows(tmp_path / "runs/r/metrics.jsonl")
    assert [r["epoch"] for r in rows] == [0, 1, 2, 3, 4, 5]


def test_nan_candidate_does_not_poison_update(tmp_path):
    def sometimes_nan(images, ids):
        r = images.mean(dim=(1, 2, 3))
        return {"combined": torch.where(r > r.mean(), torch.full_like(r, math.nan), r)}

    state, history = _run(_tc(tmp_path, num_epochs=2, pop_size=6, egg_rank=1, promptnorm=False, member_batch=6,
                              save_every=0), reward=sometimes_nan)
    assert bool(torch.isfinite(_flat(state.theta)).all())
    assert history[-1]["n_finite"] < 6


def test_sigterm_checkpoints_at_the_boundary(tmp_path):
    before = signal.getsignal(signal.SIGTERM)

    def on_epoch_end(epoch, scalars):
        if epoch == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    state = trainer.run_training(port_backend(), brightness, _tc(tmp_path, num_epochs=5, save_every=0),
                                 on_epoch_end=on_epoch_end, device="cpu")
    assert state.preempted and state.epoch == 2 and not state.halted
    run_dir = tmp_path / "runs/r"
    marker = json.loads((run_dir / "preempted.json").read_text())
    assert marker["epoch"] == 2 and "SIGTERM" in marker["reason"]
    assert [p.name for p in CheckpointStore(run_dir).slots()] == ["step_00000002"]
    assert signal.getsignal(signal.SIGTERM) is before  # uninstalled
    state = trainer.run_training(port_backend(), brightness, _tc(tmp_path, num_epochs=3, save_every=0), device="cpu")
    assert state.epoch == 3 and not (run_dir / "preempted.json").exists()


def test_interrupted_then_resumed_equals_uninterrupted_bitwise(tmp_path):
    straight, h_straight = _run(_tc(tmp_path / "a", num_epochs=4, save_every=1))

    def on_epoch_end(epoch, scalars):
        if epoch == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    first = trainer.run_training(port_backend(), brightness, _tc(tmp_path / "b", num_epochs=4, save_every=1),
                                 on_epoch_end=on_epoch_end, device="cpu")
    assert first.preempted and first.epoch == 2
    resumed, h_resumed = _run(_tc(tmp_path / "b", num_epochs=4, save_every=1))
    assert torch.equal(_flat(resumed.theta), _flat(straight.theta))
    for hs, hr in zip(h_straight[2:], h_resumed):
        assert hs["epoch"] == hr["epoch"]
        for k in hs:
            if k.startswith(("es/", "quality/combined", "reward/")) or k in ("theta_norm", "delta_norm"):
                assert hs[k] == hr[k], k


def _nan_from(epoch0, times=None, seed=5):
    """``es_draws`` with NaN ES noise from ``epoch0`` on (the first
    ``times`` such draws only, when given), for runs of ``seed``."""
    real = trainer.es_draws
    left = [math.inf if times is None else times]

    def draws(backend, theta, key, pop, es_cfg, count, noise=None, gen_noise=None):
        noise, gen = real(backend, theta, key, pop, es_cfg, count)
        if _epoch_of(key, seed) >= epoch0 and left[0] > 0:
            left[0] -= 1
            noise = pytree.tree_map(lambda t: torch.full_like(t, math.nan), noise)
        return noise, gen

    return draws


def test_non_finite_theta_rolls_back_then_halts(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer, "es_draws", _nan_from(1))
    state, history = _run(_tc(tmp_path, num_epochs=4, max_rollbacks=3, rollback_sigma_shrink=0.5))
    assert state.halted and not state.preempted and state.rollbacks == 4 and state.epoch == 1
    halted = json.loads((tmp_path / "runs/r/halted.json").read_text())
    assert halted["rollbacks"] == 4 and halted["epoch"] == 1 and halted["reason"] == "non-finite theta"
    rows = read_jsonl_rows(tmp_path / "runs/r/metrics.jsonl")
    assert [r["epoch"] for r in rows] == [0, 1, 1, 1, 1]
    assert [r.get("resilience/rollbacks", 0) for r in rows] == [0, 1, 2, 3, 4]
    assert [h["epoch"] for h in history] == [0]  # a tripped epoch never reaches on_epoch_end
    # each replay rebuilt the step with σ halved
    assert rows[-1]["obs/compiles"] == 4


def test_skip_policy_keeps_the_restored_theta(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer, "es_draws", _nan_from(1))
    state, _ = _run(_tc(tmp_path, num_epochs=3, rollback_policy="skip", max_rollbacks=3))
    assert not state.halted and state.epoch == 3 and state.rollbacks == 2
    slot1 = CheckpointStore(tmp_path / "runs/r").restore(state.theta)
    assert slot1.epoch == 1
    assert torch.equal(_flat(state.theta), _flat(slot1.theta))


def test_resume_keeps_a_shrunk_sigma(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer, "es_draws", _nan_from(2, times=1))
    state, history = _run(_tc(tmp_path, num_epochs=3, max_rollbacks=2))  # epoch 2 trips once, replays at σ/2
    assert [h["epoch"] for h in history] == [0, 1, 2] and state.rollbacks == 1 and not state.halted
    monkeypatch.undo()
    cfg = json.loads((tmp_path / "runs/r/ckpt/step_00000003/manifest.json").read_text())["config"]
    assert cfg["sigma"] == 0.025 and cfg["_rollbacks"] == 1
    state, history = _run(_tc(tmp_path, num_epochs=4, max_rollbacks=2))
    assert [h["epoch"] for h in history] == [3] and state.rollbacks == 1
    cfg = json.loads((tmp_path / "runs/r/ckpt/step_00000004/manifest.json").read_text())["config"]
    assert cfg["sigma"] == 0.025 and cfg["_rollbacks"] == 1


@pytest.mark.parametrize("field, value, item", [
    ("pop_shard_update", "on", "item 7"), ("desync_action", "halt", "item 7"),
    ("elastic_action", "abort", "item 7"), ("faults", "preempt@1", "item 7"), ("pop_host_shard", "on", "item 7"),
    ("desync_check_every", 4, "item 7"), ("on_topology_mismatch", "reshard", "item 7"),
    ("elastic_action", "continue", "item 7"),
])
def test_unported_settings_raise(tmp_path, field, value, item):
    with pytest.raises(NotImplementedError, match=f"{field}=.*{item}"):
        trainer.run_training(port_backend(), brightness, _tc(tmp_path, **{field: value}), device="cpu")
    assert not (tmp_path / "runs").exists()


def test_trace_spans_read_by_the_jax_reader(tmp_path):
    state, _ = _run(_tc(tmp_path, num_epochs=2, trace=True))
    names = [e["name"] for e in jload_events(tmp_path / "runs/r")]
    assert names.count("dispatch") == names.count("epoch") == 2
    assert {"setup", "plan", "compile", "log", "checkpoint"} <= set(names)
    row = read_jsonl_rows(tmp_path / "runs/r/metrics.jsonl")[-1]
    assert row["obs/phase_dispatch_seconds"]["count"] == 2 and row["obs/train_step_time_seconds"]["count"] == 2
    assert row["obs/dispatches"] == row["obs/epochs_dispatched"] == 2 and row["obs/compiles"] == 1


# ---------------------------------------------------------------------------
# host-side pieces against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pop, m, r", [(4, 3, 1), (6, 2, 3), (5, 4, 2)])
def test_quality_metrics_matches_jax(pop, m, r):
    rng = np.random.default_rng(pop * 100 + m * 10 + r)
    rewards = {k: rng.standard_normal((pop, r * m)).astype(np.float32) for k in ("clip_text", "combined")}
    rewards["combined"][0, :] = np.nan  # a whole member
    rewards["combined"][1:, 0] = np.nan  # one image of every other member
    rewards["clip_text"][:, :m] = np.nan  # every member's first repeat (all of a prompt when r = 1)
    out = quality_metrics({k: torch.from_numpy(v) for k, v in rewards.items()}, pop=pop, num_unique=m, repeats=r)
    jout = jquality_metrics({k: jnp.asarray(v) for k, v in rewards.items()}, pop=pop, num_unique=m, repeats=r)
    assert set(out) == set(jout) and len(out) == 6
    for k in jout:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=1e-6, atol=1e-6, err_msg=k)


def _scalar_stream(n=9):
    """Epoch scalars where combined rises and clip_text falls from epoch 2."""
    rows = []
    for e in range(n):
        rows.append({"images_scored": 16, "reward/combined_mean": 0.5 + 0.01 * e,
                     "reward/clip_text_mean": 0.6 - (0.01 * (e - 1) if e >= 2 else 0.0),
                     "reward/clip_aesthetic_mean": 0.4 + 0.001 * (e % 2),
                     "quality/combined/prompt_mean": [0.3 + 0.01 * e, 0.2, float("nan"), 0.25],
                     "quality/combined/prompt_best": [0.4, 0.3, 0.0, 0.35],
                     "prompts": ["p0", "p1", "p2", "p3"], "es/fitness_zero": float(e in (1, 2, 3, 5, 6))})
    return rows


def test_quality_ledger_matches_jax(tmp_path, capsys):
    ledger, jledger = QualityLedger(tmp_path / "p", hack_window=3), JQualityLedger(tmp_path / "j", hack_window=3)
    for e, s in enumerate(_scalar_stream()):
        assert ledger.observe(e, s) == jledger.observe(e, s)
    assert ledger.alerts == jledger.alerts == 1
    prows, jrows = (read_jsonl_rows(tmp_path / d / "quality.jsonl") for d in ("p", "j"))
    assert [{k: v for k, v in r.items() if k != "ts"} for r in prows] == \
        [{k: v for k, v in r.items() if k != "ts"} for r in jrows]
    assert "ALERT: reward term 'clip_text'" in capsys.readouterr().err


@pytest.mark.parametrize("threshold", [0, 2, 3])
def test_degeneracy_watchdog_matches_jax(threshold):
    fired, jfired = [], []
    wd, jwd = DegeneracyWatchdog(threshold, fired.append), JWatchdog(threshold, jfired.append)
    counts = [(wd.update(s["es/fitness_zero"] >= 0.5), jwd.update(s["es/fitness_zero"] >= 0.5))
              for s in _scalar_stream()]
    assert [a for a, _ in counts] == [b for _, b in counts]
    assert fired == jfired
    assert fired == {0: [], 2: [2, 2], 3: [3]}[threshold]


@pytest.mark.parametrize("policy", ["sigma_shrink", "skip", "halt"])
def test_rollback_controller_matches_jax(policy):
    ctrl = RollbackController(policy=policy, max_rollbacks=2, explode_norm=10.0)
    jctrl = JRollback(policy=policy, max_rollbacks=2, explode_norm=10.0)
    for v in (1.0, float("nan"), 3.0, float("inf"), 50.0, "x", None, 9.99, float("-inf")):
        assert ctrl.is_bad(v) == jctrl.is_bad(v)
        if ctrl.is_bad(v):
            assert ctrl.next_action() == jctrl.next_action()
    assert ctrl.rollbacks == jctrl.rollbacks == 4
    with pytest.raises(ValueError):
        RollbackController(policy="retry")


def test_train_config_has_every_jax_field_and_default():
    fields = {f.name: f for f in dataclasses.fields(TrainConfig)}
    jfields = {f.name: f for f in dataclasses.fields(JTrainConfig)}
    assert list(fields) == list(jfields)
    for name, f in jfields.items():
        assert fields[name].type == f.type, name
        assert fields[name].default == f.default, name
    assert TrainConfig().quality is True
    for kw in ({}, dict(pop_size=16, sigma=0.02, antithetic=False, promptnorm=False), dict(run_name="x"),
               dict(prompts_per_gen=4, batches_per_gen=3, lr_scale=0.5, egg_rank=8)):
        assert TrainConfig(**kw).auto_run_name("sana_one_step") == JTrainConfig(**kw).auto_run_name("sana_one_step")
        assert dataclasses.asdict(TrainConfig(**kw).es_config()) == dataclasses.asdict(JTrainConfig(**kw).es_config())


def test_tokenizer_fallback_matches_jax():
    prompts = ["a red square", "", "one", "an astronaut riding a horse on the moon " * 12, "ünïcode wörds here"]
    for a, b in zip(tokenize_with_hf(prompts), jtokenize(prompts)):
        b = np.array(b)
        assert a.dtype == torch.from_numpy(b).dtype
        np.testing.assert_array_equal(a.numpy(), b)


def test_flat_tree_views_match_jax():
    theta = _theta_np(4)
    t = tree_from_numpy(theta, "cpu")
    flat, jflat = pytree.tree_to_flat(t), jpytree.tree_to_flat(theta)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = pytree.flat_to_tree(flat * 2, t)
    jback = jpytree.flat_to_tree(jflat * 2, theta)
    _same_tree(back, _np(jback))
    _same_tree(pytree.zero_like_theta(t), _np(jpytree.zero_like_theta(theta)))
    assert list(pytree.flatten_with_paths(t)) == list(jpytree_flat(theta))
    with pytest.raises(ValueError):
        pytree.flat_to_tree(flat[:-1], t)


@pytest.mark.parametrize("s", ["1,2,3", "", "all", "ALL", " 4 , 5,", None, "7"])
def test_parse_int_list_matches_jax(s):
    assert parse_int_list(s) == jparse_int_list(s)


def test_metrics_registry_snapshot_matches_jax():
    reg, jreg = MetricsRegistry(), JRegistry()
    for r in (reg, jreg):
        r.inc("dispatches")
        r.inc("dispatches", 2)
        r.gauge("compile_cache_entries", None)
        r.gauge_max("device_peak_bytes_in_use", 5)
        r.gauge_max("device_peak_bytes_in_use", 3)
        for v in (0.0005, 0.3, 7.0, 500.0):
            r.observe("train_step_time_seconds", v)
    assert reg.snapshot() == jreg.snapshot()
    assert reg.snapshot()["obs/dispatches"] == 3 and "obs/compile_cache_entries" not in reg.snapshot()


def test_retry_backs_off_then_gives_up(monkeypatch):
    monkeypatch.setenv("HYPERSCALEES_RETRY_BASE_S", "0")
    reg = MetricsRegistry(prefix="resilience/")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("EIO")
        return "ok"

    assert call_with_retry(flaky, site="ckpt_read", registry=reg) == "ok" and len(calls) == 3
    snap = reg.snapshot()
    assert snap["resilience/retries"] == 2 and snap["resilience/retry/ckpt_read"] == 2
    with pytest.raises(OSError):
        call_with_retry(lambda: (_ for _ in ()).throw(OSError("EIO")), attempts=2, registry=reg)
    assert reg.snapshot()["resilience/retry_exhausted"] == 1
    missing = []
    with pytest.raises(FileNotFoundError):
        call_with_retry(lambda: missing.append(1) or open("/nonexistent/x"), registry=reg)
    assert len(missing) == 1  # a missing file is not retried


def test_preemption_handler_latches_and_restores():
    before = signal.getsignal(signal.SIGINT)
    h = PreemptionHandler().install()
    try:
        os.kill(os.getpid(), signal.SIGINT)
        assert h.requested and "SIGINT" in h.reason
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGINT) is before


def test_tracer_writes_nothing_when_off(tmp_path):
    seen = []
    tr = Tracer(None, on_span=lambda n, d: seen.append(n))
    with tr.span("a"):
        with tr.span("b"):
            pass
    assert seen == ["b", "a"] and not list(tmp_path.iterdir())
    tr = Tracer(tmp_path / "trace.jsonl")
    with tr.span("outer", k=1):
        with tr.span("inner"):
            pass
    ev = jload_events(tmp_path)
    assert [(e["name"], e["depth"], e["parent"]) for e in ev] == [("inner", 1, "outer"), ("outer", 0, None)]
    assert ev[1]["attrs"] == {"k": 1}
