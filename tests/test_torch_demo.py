"""The port's blind A/B demo (``tools/demo.py``) and vote report
(``tools/vote_report.py``) against the JAX package's on the CPU, at the tiny
Sana geometry in f32 with the JAX backend's weights, prompt embeddings and
adapter carried across.

- ``generate_one`` and ``generate_pair``: the served f32 images within 3e-4
  of the JAX engine's (measured 5.1e-7 and 6.0e-7), the uint8 images within one
  level (measured 0).
- A pair is one flush and one dispatch; its base image is bitwise the port's
  own ``generate_one("base")`` at the same seed.
- A seeded ``BlindABSession`` draws the same prompts, seeds and A/B sides as
  the JAX one; their ``votes.jsonl`` records are equal apart from ``t`` and
  ``session``. ``run_cli_trials`` with scripted input; ``build_interface``
  raises ``ImportError`` without gradio.
- ``vote_report``: ``sign_test_p``, ``report``, ``fitness_rows`` and
  ``main --out_json --fitness_out`` equal to the reference's, the files
  byte for byte.
"""

import json
import random
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.tools import demo as jdemo
from hyperscalees_t2i_tpu.tools import vote_report as jvote
from hyperscalees_t2i_tpu_torch.backends.sana_backend import SanaBackend
from hyperscalees_t2i_tpu_torch.tools import demo, vote_report
from hyperscalees_t2i_tpu_torch.train import cli
from hyperscalees_t2i_tpu_torch.weights.from_jax import adapter_from_jax, tree_from_numpy

torch.set_num_threads(1)
TOL = 3e-4
TINY = ["--backend", "sana_one_step", "--model_scale", "tiny", "--lora_r", "2", "--lora_alpha", "4"]


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("demo")
    prompts = tmp / "p.txt"
    prompts.write_text("a red cube\na blue sphere\na green cone\n")
    jeng = jdemo.make_engine(jdemo.build_parser().parse_args([*TINY, "--prompts_txt", str(prompts)]))
    theta = jeng.backend.init_theta(jax.random.PRNGKey(3))
    jeng.lora_theta = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(4), x.shape, x.dtype), theta)
    jback = jeng.backend
    cfg = cli.build_backend(demo.build_parser().parse_args([*TINY, "--prompts_txt", str(prompts)]),
                            torch.device("cpu")).cfg
    back = SanaBackend(cfg, "cpu", params=tree_from_numpy(_np(jback.params), "cpu"),
                       vae_params=tree_from_numpy(_np(jback.vae_params), "cpu"), prompts=list(jback.prompts))
    back.setup()
    back.set_prompt_embeds(torch.from_numpy(np.array(jback.prompt_embeds)))
    eng = demo.DemoEngine(back, adapter_from_jax(_np(jeng.lora_theta), "cpu"))
    return eng, jeng


@pytest.mark.parametrize("which", ["base", "lora"])
def test_generate_one_matches_jax(engines, which):
    eng, jeng = engines
    ours = eng.serve.generate(which, [1], 7)
    theirs = np.asarray(jeng.serve.generate(which, [1], 7), np.float32)
    assert ours.shape == theirs.shape == (1, 16, 16, 3)
    err = float(np.abs(ours - theirs).max())
    assert err <= TOL, err
    a, b = eng.generate_one(which, 1, seed=7), jeng.generate_one(which, 1, seed=7)
    assert a.dtype == np.uint8 and np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_generate_pair_matches_jax(engines):
    eng, jeng = engines
    ours, theirs = eng.generate_pair(2, seed=11), jeng.generate_pair(2, seed=11)
    for a, b in zip(ours, theirs):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert not np.array_equal(*ours)  # the adapter matters


def test_pair_is_one_flush_and_its_base_is_the_solo_image(engines):
    eng, _ = engines
    before = eng.serve.registry.value("serve_dispatches", 0)
    base, lora = eng.generate_pair(0, seed=5)
    assert eng.serve.registry.value("serve_dispatches", 0) == before + 1
    np.testing.assert_array_equal(base, eng.generate_one("base", 0, seed=5))
    np.testing.assert_array_equal(lora, eng.generate_one("lora", 0, seed=5))
    assert eng.serve.registry.value("serve_dispatches", 0) == before + 3


def test_seeded_session_draws_and_records_as_jax(engines, tmp_path):
    eng, jeng = engines
    ours = demo.BlindABSession(eng, rng=random.Random(5), record_dir=tmp_path / "port")
    theirs = jdemo.BlindABSession(jeng, rng=random.Random(5), record_dir=tmp_path / "jax")
    for t in range(4):
        a, b = ours.new_trial(), theirs.new_trial()
        assert (a.prompt_index, a.seed, a.mapping, a.prompt_text) == (b.prompt_index, b.seed, b.mapping, b.prompt_text)
        assert np.abs(a.img_a.astype(int) - b.img_a.astype(int)).max() <= 1
        choice = "AB"[t % 2]
        assert ours.vote(choice) == theirs.vote(choice)
    strip = lambda d: [{k: v for k, v in json.loads(l).items() if k not in ("t", "session")}  # noqa: E731
                       for l in (d / "votes.jsonl").read_text().splitlines()]
    assert strip(tmp_path / "port") == strip(tmp_path / "jax") and len(strip(tmp_path / "port")) == 4
    with pytest.raises(ValueError, match="no active trial"):
        ours.vote("A")


def test_cli_trial_loop(engines, tmp_path):
    eng, _ = engines
    session = demo.BlindABSession(eng, rng=random.Random(2), record_dir=tmp_path)
    answers = iter(["x", "a", "B"])  # invalid input re-prompts, case folds
    scores = demo.run_cli_trials(session, 2, tmp_path / "imgs", input_fn=lambda _: next(answers))
    assert scores["n_trials"] == 2 and scores["lora_wins"] + scores["base_wins"] == 2
    assert (tmp_path / "imgs" / "trial000_A.png").exists() and (tmp_path / "imgs" / "trial001_B.png").exists()
    assert len((tmp_path / "votes.jsonl").read_text().splitlines()) == 2
    assert "LoRA win rate" in demo.format_score(scores) and "no votes yet" in demo.format_score({})


def test_gradio_ui_raises_without_gradio(engines):
    eng, _ = engines
    with pytest.raises(ImportError, match="--cli N"):
        demo.build_interface(eng)
    with pytest.raises(SystemExit, match="gradio is not installed"):
        demo.main([*TINY, "--device", "cpu"])


def test_lora_side_needs_an_adapter(engines):
    eng, _ = engines
    bare = demo.DemoEngine(eng.backend, lora_theta=None)
    with pytest.raises(ValueError, match="no LoRA adapter"):
        bare.generate_one("lora", 0, seed=0)
    with pytest.raises(SystemExit, match="needs a trained adapter"):
        demo.main([*TINY, "--device", "cpu", "--cli", "1"])


def test_var_backend_has_no_guidance_knob():
    eng = demo.make_engine(demo.build_parser().parse_args(
        ["--backend", "var", "--model_scale", "tiny", "--lora_r", "2", "--device", "cpu"]))
    assert eng.default_guidance is None
    img = eng.generate_one("base", 0, seed=3)
    assert img.dtype == np.uint8 and img.shape[-1] == 3
    with pytest.raises(ValueError, match="no guidance_scale knob"):
        eng.generate_one("base", 0, seed=3, guidance_scale=2.0)


def test_make_engine_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.make_engine(demo.build_parser().parse_args(TINY))


@pytest.mark.parametrize("wins,n", [(0, 0), (5, 10), (20, 20), (0, 20), (7, 9), (3, 17), (50, 101)])
def test_sign_test_p_matches_reference(wins, n):
    assert vote_report.sign_test_p(wins, n) == jvote.sign_test_p(wins, n)


VOTES = [
    {"t": 100.0, "session": "s1", "prompt": "a cat", "winner": "lora"},
    {"t": 101.5, "session": "s1", "prompt": "a cat", "winner": "lora"},
    {"t": 102.0, "session": "s2", "prompt": "a dog", "winner": "base"},
    {"t": 103.25, "session": "s2", "prompt": "a cat", "winner": "lora"},
    {"session": "s3", "prompt": "a fox", "winner": "base"},
]


def test_report_and_fitness_rows_match_reference():
    assert vote_report.report(VOTES) == jvote.report(VOTES)
    assert vote_report.fitness_rows(VOTES) == jvote.fitness_rows(VOTES)
    assert vote_report.fitness_rows([]) == jvote.fitness_rows([]) == []
    for mod in (vote_report, jvote):
        with pytest.raises(ValueError, match="refusing to aggregate"):
            mod.report([{"winner": "tie"}])


def test_vote_report_main_writes_the_references_bytes(tmp_path, capsys):
    votes = tmp_path / "votes.jsonl"
    votes.write_text("".join(json.dumps(v) + "\n" for v in VOTES))
    out = {}
    for tag, mod in (("port", vote_report), ("jax", jvote)):
        mod.main([str(votes), "--out_json", str(tmp_path / f"{tag}.json"),
                  "--fitness_out", str(tmp_path / f"{tag}.jsonl")])
        out[tag] = capsys.readouterr().out.replace(str(tmp_path / f"{tag}.jsonl"), "F")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    assert out["port"] == out["jax"] and "5 votes" in out["port"]
