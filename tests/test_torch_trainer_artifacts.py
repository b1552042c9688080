"""The trainer's artifacts (θ/Δθ histograms, member strips, quality
snapshots, member regeneration) in the port's ``run_training`` against the
JAX package's on the CPU.

Both packages run the tiny Sana backend of ``tests/test_torch_trainer.py``
for 2 epochs with ``log_hist_every``, ``log_images_every`` and
``snapshot_every`` at 2 (so epoch 1 is due for all three and epoch 0 for
none); the port gets the JAX θ₀ and each epoch's JAX draws through its two
seams, as ``tests/test_torch_trainer.py`` injects them. Tolerances:

- ``hist/*``: the same keys, bin counts equal, edges and ``pop_scores``
  within 3e-4; ``_histograms`` bitwise on the same numpy θ;
- strips: the same best/median/worst members wherever the scores differ by
  more than 3e-4, scores within 3e-4, pixels within ±2 levels;
- the snapshot grid: the same member, pixels within ±2 levels;
- ``regenerate_member_images``: within 3e-4 of the JAX function.

``test_hist_keys_at_a_due_epoch_match_jax`` holds the rows' key sets: at
``log_hist_every=2`` a due epoch's row carries the ``hist/*`` keys, as the
JAX row does.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hyperscalees_t2i_tpu.es.noiser import sample_noise as jsample_noise
from hyperscalees_t2i_tpu.es.sampling import epoch_key as jepoch_key
from hyperscalees_t2i_tpu.models import sana as jsana
from hyperscalees_t2i_tpu.train.cli import build_parser as jbuild_parser
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import _histograms as j_histograms
from hyperscalees_t2i_tpu.train.trainer import regenerate_member_images as jregenerate
from hyperscalees_t2i_tpu.train.trainer import run_training as jrun_training
from hyperscalees_t2i_tpu_torch.train import cli, trainer
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows
from hyperscalees_t2i_tpu_torch.weights.from_jax import adapter_from_jax
from tests.test_torch_trainer import _jax_backend, _np, _with_jax_draws, brightness, jax_brightness, port_backend

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
LEVELS = 2  # strip and snapshot pixels, in 8-bit levels
ART = dict(num_epochs=2, pop_size=4, sigma=0.05, lr_scale=1.0, egg_rank=2, prompts_per_gen=2, member_batch=2,
           save_every=0, quality=True, seed=3, run_name="art", log_hist_every=2, log_images_every=2, snapshot_every=2)
HIST_KEYS = ("hist/theta", "hist/delta_theta", "hist/pop_scores")
_STRIP = re.compile(r"(best|median|worst)_member(\d+)_score(-?[\d.]+)\.png")


@pytest.fixture(scope="module")
def jax_art(tmp_path_factory):
    """One JAX ``run_training`` with every artifact due at epoch 1, its θ₀ and
    each epoch's draws."""
    root = tmp_path_factory.mktemp("jax_art")
    jb = _jax_backend(root)
    jtc = JTrainConfig(run_dir=str(root / "runs"), **ART)
    jrun_training(jb, jax_brightness, jtc)
    theta0 = jb.init_theta(jax.random.fold_in(jax.random.PRNGKey(jtc.seed), 17))
    draws = {}
    for e in range(jtc.num_epochs):
        k_noise, k_gen = jax.random.split(jepoch_key(jtc.seed, e))
        B = len(jb.step_info(e, jtc.prompts_per_gen, jtc.batches_per_gen).flat_ids)
        draws[e] = (_np(jsample_noise(k_noise, theta0, jtc.pop_size, jtc.es_config())),
                    np.asarray(jsana._per_image_normal(k_gen, jnp.arange(B), B, (4, 4, 4))))
    run_dir = root / "runs" / "art"
    return dict(jb=jb, jtc=jtc, theta0=_np(theta0), draws=draws, rows=read_jsonl_rows(run_dir / "metrics.jsonl"),
                run_dir=run_dir)


def _port_run(jax_art, root, **overrides):
    with pytest.MonkeyPatch.context() as mp:
        _with_jax_draws(mp, jax_art["theta0"], jax_art["draws"], seed=ART["seed"])
        trainer.run_training(port_backend(jax_art["jb"]), brightness,
                             TrainConfig(run_dir=str(root / "runs"), **{**ART, **overrides}), device="cpu")
    run_dir = root / "runs" / "art"
    return dict(rows=read_jsonl_rows(run_dir / "metrics.jsonl"), run_dir=run_dir)


@pytest.fixture(scope="module")
def port_art(jax_art, tmp_path_factory):
    return _port_run(jax_art, tmp_path_factory.mktemp("port_art"))


def test_hist_rows_match_jax(jax_art, port_art):
    jrows, prows = jax_art["rows"], port_art["rows"]
    assert [r["epoch"] for r in prows] == [r["epoch"] for r in jrows] == [0, 1]
    assert not any(k in prows[0] or k in jrows[0] for k in HIST_KEYS)  # epoch 0 is not due
    jr, pr = jrows[1], prows[1]
    for k in ("hist/theta", "hist/delta_theta"):
        assert len(pr[k]["counts"]) == len(jr[k]["counts"]) == 64 and len(pr[k]["edges"]) == 65
        assert pr[k]["counts"] == jr[k]["counts"], k
        np.testing.assert_allclose(pr[k]["edges"], jr[k]["edges"], err_msg=k, **TOL)
    assert sum(pr["hist/delta_theta"]["counts"]) > 0
    assert len(pr["hist/pop_scores"]) == ART["pop_size"]
    np.testing.assert_allclose(pr["hist/pop_scores"], jr["hist/pop_scores"], **TOL)


def test_hist_keys_at_a_due_epoch_match_jax(jax_art, tmp_path):
    """The rows' key sets agree outside ``obs/`` (each package's own
    counters) at ``log_hist_every=2`` with nothing else due: the due epoch
    carries the three ``hist/*`` keys in both."""
    prows = _port_run(jax_art, tmp_path, log_images_every=0, snapshot_every=0)["rows"]
    for jr, pr in zip(jax_art["rows"], prows):
        assert {k for k in pr if not k.startswith("obs/")} == {k for k in jr if not k.startswith("obs/")}, jr["epoch"]
    assert set(HIST_KEYS) <= set(prows[1])


def _theta_pair(seed, shapes):
    rng = np.random.default_rng(seed)
    return [{k: {f: rng.standard_normal(s).astype(np.float32) for f, s in fs.items()} for k, fs in shapes.items()}
            for _ in range(2)]


@pytest.mark.parametrize("shapes", [
    {"blocks/attn": {"a": (2, 24, 2), "b": (2, 2, 24)}, "blocks/ff": {"a": (2, 24, 2), "b": (2, 2, 48)}},
    # 60,000 values: subsampled to 50,000 in both
    {"x": {"a": (300, 100), "b": (100, 300)}, "w": {"a": (50, 200), "b": (200, 50)}},
])
def test_histograms_bitwise_on_the_same_theta(shapes):
    before, after = _theta_pair(11, shapes)
    scores = np.array([0.5, -1.25, np.nan, 2.0], np.float32)
    ours = trainer._histograms({k: {f: torch.from_numpy(a) for f, a in d.items()} for k, d in before.items()},
                               {k: {f: torch.from_numpy(a) for f, a in d.items()} for k, d in after.items()}, scores)
    ref = j_histograms(jax.tree_util.tree_map(jnp.asarray, before), jax.tree_util.tree_map(jnp.asarray, after), scores)
    assert ours.keys() == ref.keys()
    for k in ("hist/theta", "hist/delta_theta"):
        assert ours[k] == ref[k], k
    np.testing.assert_array_equal(ours["hist/pop_scores"], ref["hist/pop_scores"])


def _strips(run_dir):
    out = {}
    for p in (run_dir / "epoch_0001").glob("*.png"):
        kind, member, score = _STRIP.fullmatch(p.name).groups()
        with Image.open(p) as im:
            out[kind] = (int(member), float(score), np.asarray(im.convert("RGB")).astype(int))
    return out


def test_strips_match_jax(jax_art, port_art):
    ours, ref = _strips(port_art["run_dir"]), _strips(jax_art["run_dir"])
    assert set(ours) == set(ref) == {"best", "median", "worst"}
    scores = np.sort(np.asarray(jax_art["rows"][1]["hist/pop_scores"], np.float64))
    separated = np.all(np.diff(scores) > 3e-4)
    worst = 0
    for kind in ours:
        if separated:
            assert ours[kind][0] == ref[kind][0], kind
        assert abs(ours[kind][1] - ref[kind][1]) <= 3e-4 + 5e-5, kind  # names round to 4 decimals
        assert ours[kind][2].shape == ref[kind][2].shape == (256, 256 * ART["prompts_per_gen"], 3)
        worst = max(worst, int(np.abs(ours[kind][2] - ref[kind][2]).max()))
    print(f"strip pixels: max diff {worst} levels")
    assert worst <= LEVELS


def test_snapshot_matches_jax(jax_art, port_art):
    (ours,), (ref,) = (sorted((r / "snapshots").glob("*.png")) for r in (port_art["run_dir"], jax_art["run_dir"]))
    assert ours.name.split("_score")[0] == ref.name.split("_score")[0]  # epoch and member
    with Image.open(ours) as a, Image.open(ref) as b:
        a, b = np.asarray(a.convert("RGB")).astype(int), np.asarray(b.convert("RGB")).astype(int)
    assert a.shape == b.shape == (256, 256 * ART["prompts_per_gen"], 3)
    print(f"snapshot pixels: max diff {int(np.abs(a - b).max())} levels")
    assert int(np.abs(a - b).max()) <= LEVELS


@pytest.mark.parametrize("epoch, member", [(0, 0), (1, 3)])
def test_regenerate_member_images_matches_jax(jax_art, epoch, member):
    jb, jtc = jax_art["jb"], jax_art["jtc"]
    info = jb.step_info(epoch, jtc.prompts_per_gen, jtc.batches_per_gen)
    ref = jregenerate(jb, jax.tree_util.tree_map(jnp.asarray, jax_art["theta0"]), jtc, epoch, member, info)
    backend = port_backend(jb)
    backend.setup()
    ours = trainer.regenerate_member_images(backend, adapter_from_jax(jax_art["theta0"], "cpu"), TrainConfig(**ART),
                                            epoch, member, info)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, **TOL)


def test_cli_artifact_flags_reach_train_config():
    argv = ["--backend", "sana_one_step", "--log_images_every", "3", "--log_hist_every", "4", "--profile_epochs", "2",
            "--snapshot_every", "5"]
    ours, ref = cli.build_parser().parse_args(argv), jbuild_parser().parse_args(argv)
    tc = cli.train_config(ours)
    for field in ("log_images_every", "log_hist_every", "profile_epochs", "snapshot_every"):
        assert getattr(ours, field) == getattr(ref, field) == getattr(tc, field), field
    assert (tc.log_images_every, tc.log_hist_every, tc.profile_epochs, tc.snapshot_every) == (3, 4, 2, 5)
