"""Port parity: one EGGROLL-ES epoch step of the Infinity backend, tiny, f32.

The JAX package's ``make_es_step`` runs its tiny Infinity backend (the JAX
CLI's ``--model_scale tiny`` geometry, pop 4, 4 prompts with hash-fallback
text features, 1 repeat, member_batch 2: two members a lane pair) with the
JAX tiny CLIP reward. Weights, the text features and mask, adapter, CLIP
tower and text table are the JAX package's, carried over; the JAX ES noise
and JAX's own sampling noise (``jax.random.gumbel`` of ``fold_in(fold_in(
k_gen, si), i)`` of shape ``[pn², bits, 2]``, image ``i`` at scale ``si``)
are injected (``noise=``/``gen_noise=``). The JAX reward suite hands each
call's rewards to the host through an ordered ``jax.debug.callback``.

Bound 3e-4 on θ′, the opt scores, the reward rows and every metric shared
by name (measured: θ′ 3.1e-7, reward rows 1.2e-7, the standardized opt
scores and the metrics ≤ 1.5e-5); the metric names agree exactly.
Within the port, member_batch 1, 2 and 4 agree at rtol/atol 1e-5. A tiny
``--backend infinity`` run of the CLI writes its metrics and slots.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.backends.base import make_frozen
from hyperscalees_t2i_tpu.backends.infinity_backend import InfinityBackend as JBackend
from hyperscalees_t2i_tpu.backends.infinity_backend import InfinityBackendConfig as JConfig
from hyperscalees_t2i_tpu.es.noiser import sample_noise as jsample_noise
from hyperscalees_t2i_tpu.models import clip as jclip
from hyperscalees_t2i_tpu.models import infinity as jinf
from hyperscalees_t2i_tpu.rewards import suite as jsuite
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import make_es_step as jmake_es_step
from hyperscalees_t2i_tpu.utils.prompt_cache import save_infinity_cache as jsave_infinity_cache
from hyperscalees_t2i_tpu_torch.backends.infinity_backend import InfinityBackend, build_train_backend
from hyperscalees_t2i_tpu_torch.models import infinity as tinf
from hyperscalees_t2i_tpu_torch.resilience.checkpoints import CheckpointStore
from hyperscalees_t2i_tpu_torch.rewards.suite import make_clip_reward_fn
from hyperscalees_t2i_tpu_torch.rungs import RUNG_OPT, RUNG_PLAN, infinity_rung_model
from hyperscalees_t2i_tpu_torch.train import cli
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.train.trainer import make_es_step
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows
from hyperscalees_t2i_tpu_torch.weights.from_jax import adapter_from_jax, clip_from_jax, tree_from_numpy

from test_torch_infinity import _np, jax_gumbel, port_cfg, tiny_cfg
from test_torch_var_step import _HostRows, _jax_clip_cfg

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
POP, M, SIGMA = 4, 4, 0.01
PROMPTS = ["a red square", "a blue circle", "a green cat", "a woman reading"]


def _port_backend(jb):
    backend = InfinityBackend(infinity_rung_model("tiny")["bcfg"], "cpu", params=tree_from_numpy(_np(jb.params), "cpu"),
                              prompts=jb.prompts, text=(torch.from_numpy(np.array(jb.text_emb)),
                                                        torch.from_numpy(np.array(jb.text_mask))))
    backend.setup()
    return backend


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    path = tmp_path_factory.mktemp("inf") / "prompts.txt"
    path.write_text("\n".join(PROMPTS) + "\n")
    jb = JBackend(JConfig(model=tiny_cfg(), prompts_txt_path=str(path)))
    jb.setup()
    jb.params = jax.tree_util.tree_map_with_path(
        lambda p, a: a if "kernel" in jax.tree_util.keystr(p)
        else a + 0.05 * jax.random.normal(jax.random.PRNGKey(a.size), a.shape), jb.params)
    ccfg = _jax_clip_cfg()
    cparams = jclip.init_clip(jax.random.PRNGKey(6), ccfg)
    table = jsuite.clip_text_embed_table(
        cparams, ccfg, jax.random.randint(jax.random.PRNGKey(7), (jb.num_items + 2, 8), 0, ccfg.vocab_size))
    theta = jb.init_theta(jax.random.PRNGKey(1))
    theta = jax.tree_util.tree_map(lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(3), x.shape), theta)

    jreward = _HostRows(jsuite.make_clip_reward_fn(cparams, ccfg, table))
    jtc = JTrainConfig(pop_size=POP, sigma=SIGMA, egg_rank=4, prompts_per_gen=M, batches_per_gen=1,
                       member_batch=2, promptnorm=True)
    info = jb.step_info(0, M, 1)
    key = jax.random.PRNGKey(2)
    k_noise, k_gen = jax.random.split(key)
    step = jmake_es_step(jb, jreward, jtc, M, 1, donate=False)
    jtheta, jmetrics, jopt = step(make_frozen(jb, jreward), theta, jnp.asarray(info.flat_ids, jnp.int32), key)
    jax.effects_barrier()
    jrows = {k: np.concatenate([c[k].reshape(-1, M) for c in jreward.calls]) for k in jreward.calls[0]}
    assert jrows["combined"].shape == (POP, M)
    noise = jsample_noise(k_noise, theta, POP, jtc.es_config())

    backend = _port_backend(jb)
    reward = make_clip_reward_fn(clip_from_jax(_np(cparams), infinity_rung_model("tiny")["clip_b"], "cpu"),
                                 torch.from_numpy(np.array(table)))
    inputs = dict(theta=adapter_from_jax(_np(theta), "cpu"), noise=tree_from_numpy(_np(noise), "cpu"),
                  gen=torch.from_numpy(jax_gumbel(k_gen, jb.cfg.model, M)), flat=info.flat_ids)
    return dict(jb=jb, jout=(jtheta, jmetrics, jopt, jrows), backend=backend, reward=reward, inputs=inputs)


def _run_port(p, member_batch, inject=True):
    calls = []

    def recording_reward(images, ids):
        out = p["reward"](images, ids)
        calls.append(out)
        return out

    i = p["inputs"]
    tc = TrainConfig(pop_size=POP, sigma=SIGMA, egg_rank=4, member_batch=member_batch)
    draws = dict(noise=i["noise"], gen_noise=i["gen"]) if inject else {}
    theta, metrics, opt = make_es_step(p["backend"], recording_reward, tc, M, 1, device="cpu")(
        i["theta"], i["flat"], threefry.prng_key(2, "cpu"), **draws)
    rows = {k: torch.cat([c[k].reshape(-1, M) for c in calls]).numpy() for k in calls[0]}
    return theta, metrics, opt, rows


def test_infinity_step_matches_jax(parts):
    _assert_step_matches_jax(parts, _run_port(parts, 2))


def test_infinity_step_with_nothing_injected_matches_jax(parts):
    """The port draws the ES noise and every image's per-scale Gumbel noise
    from the JAX program's key itself."""
    _assert_step_matches_jax(parts, _run_port(parts, 2, inject=False))


def _assert_step_matches_jax(parts, port):
    jtheta, jmetrics, jopt, jrows = parts["jout"]
    theta, metrics, opt, rows = port
    for p in jtheta:
        for f in jtheta[p]:
            np.testing.assert_allclose(theta[p][f].numpy(), np.asarray(jtheta[p][f]), err_msg=p, **TOL)
    np.testing.assert_allclose(opt.numpy(), np.asarray(jopt), **TOL)
    for k in jrows:
        assert rows[k].shape == (POP, M)
        np.testing.assert_allclose(rows[k], jrows[k], **TOL)
    for k in jmetrics:
        np.testing.assert_allclose(np.asarray(metrics[k], np.float64), np.asarray(jmetrics[k], np.float64),
                                   err_msg=k, **TOL)
    assert set(metrics) == set(jmetrics)
    assert float(metrics["delta_norm"]) > 0 and "blocks/cross_kv" in theta


@pytest.mark.parametrize("member_batch", [1, 2, 4])
def test_member_batch_lanes_equal_solo(parts, member_batch):
    base_theta, _, base_opt, base_rows = _run_port(parts, 1)
    theta, _, opt, rows = _run_port(parts, member_batch)
    for k in base_rows:
        np.testing.assert_allclose(rows[k], base_rows[k], rtol=1e-5, atol=1e-5)
    for p in base_theta:
        for f in base_theta[p]:
            np.testing.assert_allclose(theta[p][f].numpy(), base_theta[p][f].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(opt.numpy(), base_opt.numpy(), rtol=1e-5, atol=1e-5)


def test_gen_noise_is_gumbel_and_seeded(parts):
    backend = parts["backend"]
    assert backend.noise_shape == (21, 4, 2)
    noise = backend.sample_gen_noise(threefry.prng_key(0, "cpu"), range(64))
    assert noise.shape == (64, 21, 4, 2) and bool(torch.isfinite(noise).all())
    assert abs(float(noise.mean()) - 0.5772) < 0.03 and abs(float(noise.var()) - 1.6449) < 0.08
    # a served image draws its noise from (key, its position) only
    one = backend.generate(None, [1], threefry.prng_key(3, "cpu"))
    two = backend.generate(None, [1, 2], threefry.prng_key(3, "cpu"))
    torch.testing.assert_close(one[0], two[0])


def test_encoded_prompt_cache_feeds_the_backend(parts, tmp_path):
    jb = parts["jb"]
    path = str(tmp_path / "enc.npz")
    jsave_infinity_cache(path, jb.prompts, np.array(jb.text_emb), np.array(jb.text_mask))
    cfg = dataclasses.replace(infinity_rung_model("tiny")["bcfg"], encoded_prompt_path=path)
    backend = InfinityBackend(cfg, "cpu", params=tree_from_numpy(_np(jb.params), "cpu"))
    backend.setup()
    assert backend.prompts == jb.prompts and backend.prompt_cache_sha is not None
    np.testing.assert_array_equal(backend.text_emb.numpy(), np.array(jb.text_emb))
    np.testing.assert_array_equal(backend.text_mask.numpy(), np.array(jb.text_mask))
    ids = [[0, 1], [2, 3]]
    noise = parts["inputs"]["gen"].reshape(2, 2, *backend.noise_shape)
    with torch.inference_mode():
        torch.testing.assert_close(backend.generate_p(None, ids, None, noise=noise),
                                   parts["backend"].generate_p(None, ids, None, noise=noise))


def test_hash_fallback_text_is_shaped_as_the_jax_package(parts):
    jb = parts["jb"]
    backend = InfinityBackend(infinity_rung_model("tiny")["bcfg"], "cpu", prompts=list(PROMPTS))
    backend.setup()
    assert tuple(backend.text_emb.shape) == tuple(jb.text_emb.shape) == (4, 16, 12)
    np.testing.assert_array_equal(backend.text_mask.numpy(), np.array(jb.text_mask))
    # the same features: fold_in(PRNGKey(777), stable_text_seed(p)) in both packages
    np.testing.assert_allclose(backend.text_emb.numpy(), np.array(jb.text_emb), rtol=0, atol=1e-6)


def test_rung_and_build_train_backend():
    assert RUNG_PLAN["inf_2b"] == ("2b", 4, 4, 1)
    assert not RUNG_OPT["inf_2b"]["pop_fuse"] and RUNG_OPT["inf_2b"]["base_quant"] == "off"
    spec = infinity_rung_model("2b")
    assert spec["clip_h"] is not None and spec["clip_b"].vision.d_model == 768 and spec["clip_h"].vision.d_model == 1280
    backend, reward = build_train_backend("tiny", device="cpu", seed=0)
    assert backend.num_items == 8 and reward.pick_model is None
    assert not any(hasattr(m, "q8") for m in backend.model.modules())
    assert len(backend.model.lora_sites()) == 2 * 7


def test_cli_tiny_infinity_run(tmp_path, capsys):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("# a comment\na red square\n\na blue circle\na green cat\n")
    argv = ["--backend", "infinity", "--model_scale", "tiny", "--device", "cpu", "--num_epochs", "2", "--pop_size", "4",
            "--prompts_per_gen", "2", "--save_every", "1", "--run_name", "inf", "--run_dir", str(tmp_path),
            "--prompts_txt", str(prompts), "--cfg_list", "3,2", "--tau_list", "0.7"]
    assert cli.main(argv) is None
    run_dir = tmp_path / "inf"
    rows = read_jsonl_rows(run_dir / "metrics.jsonl")
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all(len(r["quality/combined/prompt_mean"]) == 2 for r in rows)
    assert [p.name for p in CheckpointStore(run_dir).slots()] == ["step_00000001", "step_00000002"]
    assert "training done at epoch 2" in capsys.readouterr().out
    args = cli.build_parser().parse_args(argv)
    backend = cli.build_backend(args, torch.device("cpu"))
    assert backend.cfg.cfg_list == (3.0, 2.0) and backend.cfg.tau_list == (0.7,)
    assert backend.cfg.model == infinity_rung_model("tiny")["bcfg"].model


def test_cli_builds_the_inf_2b_model_and_refuses_what_is_not_ported(tmp_path, monkeypatch):
    # --infinity_variant means what it means in the JAX CLI, 2b included: the
    # preset (no QK-l2, no 2D RoPE, a 16-bit tokenizer); the released
    # Infinity-2B configuration is the inf_2b rung's
    args = cli.build_parser().parse_args(["--backend", "infinity", "--infinity_variant", "2b", "--pn", "1M"])
    assert cli.infinity_model(args) != infinity_rung_model("2b")["bcfg"].model
    assert infinity_rung_model("2b")["bcfg"].model == tinf.released_config("2b", "1M")
    pns = jinf.PN_PRESETS["1M"]
    for variant in ("2b", "8b", "layer12"):
        j = jinf.from_preset(variant)
        j = dataclasses.replace(j, patch_nums=pns, vq=dataclasses.replace(j.vq, patch_nums=pns))
        m = cli.infinity_model(cli.build_parser().parse_args(["--backend", "infinity", "--infinity_variant", variant,
                                                              "--pn", "1M"]))
        f32 = dict(compute_dtype=torch.float32)
        assert dataclasses.replace(m, vq=dataclasses.replace(m.vq, **f32), **f32) == port_cfg(j)
    # --pop_fuse and --base_quant int8 build the backend as the JAX CLI does
    # (the int8 floor lowered so that the tiny blocks quantize)
    tiny = ["--backend", "infinity", "--model_scale", "tiny"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HSES_BASE_QUANT_MIN_SIZE", "512")
        args = cli.build_parser().parse_args(tiny + ["--pop_fuse", "true", "--base_quant", "int8"])
        backend = cli.build_backend(args, torch.device("cpu"))
    backend.setup()
    assert cli.train_config(args).pop_fuse and cli.train_config(args).base_quant == "int8"
    assert all(hasattr(getattr(b, k), "q8") for b in backend.model.blocks for k in tinf.INFINITY_LORA_TARGETS)
    assert hasattr(backend.model.ada_lin, "q8") and not hasattr(backend.model.vq.phi[0], "q8")
    assert any(p.endswith("kernel_q8/q8") for p in _shape_paths(backend.param_shapes))
    # --vae_weights: a BSQ tokenizer checkpoint (the tiny tokenizer's 4 bits
    # and 2 φ convs, CompVis layout) replaces the random one, as in the JAX CLI
    from test_torch_weights_infinity import bsq_sd
    from hyperscalees_t2i_tpu.weights.infinity import convert_bsq_vae as jconvert_bsq_vae

    sd = bsq_sd(17)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "bsq.pth")
    backend = cli.build_backend(cli.build_parser().parse_args(tiny + ["--vae_weights", str(tmp_path / "bsq.pth")]),
                                torch.device("cpu"))
    built, real = [], tinf.InfinityTransformer
    monkeypatch.setattr(tinf, "InfinityTransformer", lambda c, p: built.append(p) or real(c, p))
    backend.setup()
    want = jconvert_bsq_vae(sd, tiny_cfg().vq)
    vq = built[0]["vq"]
    assert "mid" in vq["decoder"] and np.array_equal(vq["phi"]["kernel"].numpy(), np.asarray(want["phi"]["kernel"]))
    assert np.array_equal(vq["decoder"]["conv_out"]["kernel"].numpy(), np.asarray(want["decoder"]["conv_out"]["kernel"]))


def _shape_paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _shape_paths(v, f"{prefix}{k}/")
        elif isinstance(v, (list, tuple)):
            for i, w in enumerate(v):
                if isinstance(w, dict):
                    yield from _shape_paths(w, f"{prefix}{k}/{i}/")
        else:
            yield f"{prefix}{k}"


def test_cli_tiny_infinity_run_int8_pop_fuse(tmp_path, monkeypatch, capsys):
    """The tiny CLI with ``--pop_fuse true --base_quant int8`` (the int8
    floor lowered so that the tiny blocks quantize) writes its metrics and
    slots."""
    monkeypatch.setenv("HSES_BASE_QUANT_MIN_SIZE", "512")
    argv = ["--backend", "infinity", "--model_scale", "tiny", "--device", "cpu", "--num_epochs", "2", "--pop_size", "4",
            "--prompts_per_gen", "2", "--member_batch", "2", "--save_every", "1", "--run_name", "q8", "--run_dir",
            str(tmp_path), "--pop_fuse", "true", "--base_quant", "int8"]
    assert cli.main(argv) is None
    run_dir = tmp_path / "q8"
    rows = read_jsonl_rows(run_dir / "metrics.jsonl")
    assert [r["epoch"] for r in rows] == [0, 1] and all(np.isfinite(r["theta_norm"]) for r in rows)
    assert [p.name for p in CheckpointStore(run_dir).slots()] == ["step_00000001", "step_00000002"]
    assert "training done at epoch 2" in capsys.readouterr().out


def test_infinity_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InfinityBackend(infinity_rung_model("tiny")["bcfg"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_backend("tiny")
    with pytest.raises(RuntimeError):
        InfinityBackend(infinity_rung_model("tiny")["bcfg"], "cuda")


def test_run_training_from_a_seed_matches_jax(tmp_path):
    """Nothing injected: the JAX ``run_training`` and the port's, each on the
    tiny Infinity backend it builds from ``seed_params`` and the prompt
    file (hash text features), from the same seed: every shared
    ``metrics.jsonl`` value and the epoch-2 slot's θ within 3e-4."""
    from hyperscalees_t2i_tpu.train.trainer import run_training as jrun_training
    from hyperscalees_t2i_tpu_torch.train import trainer

    from test_torch_trainer import _assert_rows_match, brightness, jax_brightness

    path = tmp_path / "prompts.txt"
    path.write_text("\n".join(PROMPTS) + "\n")
    kw = dict(num_epochs=2, pop_size=POP, sigma=0.05, egg_rank=2, prompts_per_gen=2, member_batch=2, save_every=1,
              quality=True, seed=3, run_name="seed")
    jb = JBackend(JConfig(model=tiny_cfg(), prompts_txt_path=str(path)))
    jb.setup()
    jrun_training(jb, jax_brightness, JTrainConfig(run_dir=str(tmp_path / "jax"), **kw))
    cfg = dataclasses.replace(infinity_rung_model("tiny")["bcfg"], prompts_txt_path=str(path))
    trainer.run_training(InfinityBackend(cfg, "cpu"), brightness, TrainConfig(run_dir=str(tmp_path / "port"), **kw),
                         device="cpu")
    jdir, pdir = tmp_path / "jax" / "seed", tmp_path / "port" / "seed"
    _assert_rows_match(read_jsonl_rows(jdir / "metrics.jsonl"), read_jsonl_rows(pdir / "metrics.jsonl"))
    slot = "ckpt/step_00000002/theta.npz"
    with np.load(jdir / slot) as jz, np.load(pdir / slot) as pz:
        assert set(jz.files) == set(pz.files)
        for k in jz.files:
            np.testing.assert_allclose(pz[k], jz[k], err_msg=k, **TOL)


def test_inf_2b_theta0_is_the_jax_theta0():
    """The ``inf_2b`` rung's θ₀ at full size, ``init_theta(fold_in(PRNGKey(0),
    17))`` over the released Infinity-2B tree, equals the JAX package's
    ``init_lora`` from the same key (the shapes from ``jax.eval_shape``,
    meta tensors in the port). Its norm, 42.33, is above the CLI's
    ``theta_max_norm`` of 40: the JAX θ₀ starts capped too."""
    from hyperscalees_t2i_tpu.es.caps import global_norm as jglobal_norm
    from hyperscalees_t2i_tpu.lora import LoRASpec as JSpec
    from hyperscalees_t2i_tpu.lora import init_lora as jinit_lora
    from hyperscalees_t2i_tpu.models import bsq as jbsq
    from hyperscalees_t2i_tpu_torch.es.caps import global_norm
    from hyperscalees_t2i_tpu_torch.lora import LoRASpec, init_lora

    pns = jinf.PN_PRESETS["1M"]
    j = jinf.from_preset("2b", attn_l2_norm=True, use_rope2d=True, cross_attn_l2_norm=True, patch_nums=pns,
                         vq=jbsq.BSQConfig(bits=32, patch_nums=pns))
    assert port_cfg(j) == dataclasses.replace(tinf.released_config("2b", "1M"), compute_dtype=torch.float32,
                                              vq=port_cfg(j).vq)
    shapes = jax.eval_shape(lambda k: jinf.init_infinity(k, j), jax.random.PRNGKey(0))
    c = infinity_rung_model("2b")["bcfg"]
    jtheta = jinit_lora(jax.random.fold_in(jax.random.PRNGKey(0), 17), shapes, JSpec(c.lora_r, c.lora_alpha,
                                                                                      c.lora_targets))
    meta = jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), shapes)
    theta = init_lora(meta, LoRASpec(c.lora_r, c.lora_alpha, c.lora_targets),
                      threefry.fold_in(threefry.prng_key(0, "cpu"), 17), device=torch.device("cpu"))
    assert sorted(theta) == sorted(jtheta)
    for k in jtheta:
        np.testing.assert_allclose(theta[k]["a"].numpy(), np.asarray(jtheta[k]["a"]), rtol=0, atol=1e-6)
    norm, jnorm = float(global_norm(theta)), float(jglobal_norm(jtheta))
    assert abs(norm - jnorm) < 1e-4 and norm > TrainConfig().theta_max_norm == 40.0, (norm, jnorm)
