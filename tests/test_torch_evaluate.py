"""The port's evaluation harness (``evaluate/``) against the JAX package's on
the CPU, at the tiny Sana geometry in f32.

- ``slugify`` and ``parse_index``: equal to the reference on its cases.
- ``run_benchmark``, base and lora: the JAX ``main`` against the port's
  ``generate_folder`` over the same prompts, the JAX backend's weights and
  prompt embeddings carried across by ``weights/from_jax.py`` and, for lora,
  θ read by the port from a JAX-written checkpoint. File names equal; pixels
  before ``to_uint8`` within 3e-4 (the golden bound; measured 6.0e-8 and
  1.8e-7); the PNG files within one level (measured 0 and 1). The port's
  ``main`` from a seed, nothing injected, writes the same names within one
  level.
- ``score_folder --tiny_towers`` on one folder: the same report keys, every
  mean within 3e-4 (measured ≤ 7.2e-7), equal ``num_images``.
- The bundled ``data/parti_prompts_sample.tsv`` through generate → score in
  each package: per-Category and per-Challenge means within 3e-4 (measured
  ≤ 7.2e-7).
- ``--tp 2`` outside a launch of 2 processes raises by name before it
  builds anything (``tests/test_torch_tp.py`` runs it in one); every entry
  point without a card and without ``--device cpu`` raises.
"""

import csv
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.evaluate import run_benchmark as jrb
from hyperscalees_t2i_tpu.evaluate import score_folder as jsf
from hyperscalees_t2i_tpu.train import checkpoints as jckpt
from hyperscalees_t2i_tpu.train import cli as jcli
from hyperscalees_t2i_tpu_torch.backends.sana_backend import SanaBackend
from hyperscalees_t2i_tpu_torch.evaluate import run_benchmark, score_folder
from hyperscalees_t2i_tpu_torch.train import cli
from hyperscalees_t2i_tpu_torch.utils.images import read_png
from hyperscalees_t2i_tpu_torch.weights.from_jax import tree_from_numpy

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
TSV = REPO / "data" / "parti_prompts_sample.tsv"
TOL = 3e-4
TINY = ["--backend", "sana_one_step", "--model_scale", "tiny", "--lora_r", "2", "--lora_alpha", "4"]
PROMPTS = "a red square\na blue circle\na green cat\n"
PARTI = ("Prompt\tCategory\tChallenge\na red square\tAbstract\tSimple\na blue circle\tAbstract\tSimple\n"
         "a green cat\tAnimals\tImagination\n")


@pytest.mark.parametrize("text", ["A cat, on a mat!", "???", "x" * 200, "  Émile's   café -- 2 ", ""])
def test_slugify_matches_reference(text):
    assert run_benchmark.slugify(text) == jrb.slugify(text)
    assert len(run_benchmark.slugify(text)) <= 48


@pytest.mark.parametrize("name", ["0042_a-cat.png", "7-x.png", "nope.png", "0003.png", "12_.jpg", "a_1.png",
                                  "dir/0009_b.png"])
def test_parse_index_matches_reference(name):
    assert score_folder.parse_index(name) == jsf.parse_index(name)


@pytest.fixture(scope="module")
def jax_backend(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jb")
    (tmp / "p.txt").write_text(PROMPTS)
    args = jcli.build_parser().parse_args([*TINY, "--prompts_txt", str(tmp / "p.txt")])
    back = jcli.build_backend(args)
    back.setup()
    return back, tmp / "p.txt"


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _port_backend(jback, prompts_txt):
    """The port's tiny Sana backend holding the JAX backend's weights and
    prompt embeddings."""
    args = cli.build_parser().parse_args([*TINY, "--prompts_txt", str(prompts_txt), "--device", "cpu"])
    cfg = cli.build_backend(args, torch.device("cpu")).cfg
    back = SanaBackend(cfg, "cpu", params=tree_from_numpy(_np(jback.params), "cpu"),
                       vae_params=tree_from_numpy(_np(jback.vae_params), "cpu"), prompts=list(jback.prompts))
    back.setup()
    back.set_prompt_embeds(torch.from_numpy(np.array(jback.prompt_embeds)))
    return back


def _jax_images(monkeypatch, argv):
    """The JAX ``main``'s images before ``to_uint8``, by file name."""
    from hyperscalees_t2i_tpu.utils import images as jimages

    seen, save = {}, jimages.save_image

    def record(img, path):
        seen[Path(path).name] = np.asarray(img, np.float32)
        save(img, path)

    monkeypatch.setattr(jimages, "save_image", record)
    jrb.main(argv)
    monkeypatch.setattr(jimages, "save_image", save)
    return seen


def _lora_run_dir(jback, run_dir):
    theta = jback.init_theta(jax.random.PRNGKey(0))
    theta = jax.tree_util.tree_map(lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(4), x.shape), theta)
    jckpt.save_checkpoint(run_dir, theta, 5, 1.0, jback.name)
    return run_dir


@pytest.mark.parametrize("mode", ["base", "lora"])
def test_benchmark_matches_jax_with_carried_weights(tmp_path, monkeypatch, jax_backend, mode):
    jback, prompts = jax_backend
    extra = ["--mode", "lora", "--adapter_run_dir", str(_lora_run_dir(jback, tmp_path / "run"))] \
        if mode == "lora" else []
    theirs = _jax_images(monkeypatch, [*TINY, "--prompts_txt", str(prompts), "--out_dir", str(tmp_path / "jax"),
                                       "--batch_size", "2", *extra])
    back = _port_backend(jback, prompts)
    theta = run_benchmark.load_theta(back, mode, str(tmp_path / "run") if mode == "lora" else None)
    sink = []
    paths = run_benchmark.generate_folder(back, theta, tmp_path / "port", batch_size=2, sink=sink)
    names = [p.name for p in paths]
    assert names == sorted(theirs) == ["0000_a-red-square.png", "0001_a-blue-circle.png", "0002_a-green-cat.png"]
    err = max(float(np.abs(ours - theirs[n]).max()) for ours, n in zip(sink, names))
    assert err <= TOL, err
    for n in names:
        a, b = read_png(tmp_path / "port" / n).astype(int), read_png(tmp_path / "jax" / n).astype(int)
        assert np.abs(a - b).max() <= 1
    # the port's main from a seed, nothing injected: the same files within a level
    run_benchmark.main([*TINY, "--prompts_txt", str(prompts), "--out_dir", str(tmp_path / "main"),
                        "--batch_size", "2", "--device", "cpu", *extra])
    assert sorted(p.name for p in (tmp_path / "main").glob("*.png")) == names
    for n in names:
        a, b = read_png(tmp_path / "main" / n).astype(int), read_png(tmp_path / "jax" / n).astype(int)
        assert np.abs(a - b).max() <= 1
    if mode == "lora":
        base = run_benchmark.generate_folder(back, run_benchmark.load_theta(back, "base", None), tmp_path / "b", 2)
        assert any((read_png(p) != read_png(q)).any() for p, q in zip(base, paths))


def test_generate_folder_keeps_one_program_per_batch_geometry(tmp_path, jax_backend):
    from hyperscalees_t2i_tpu_torch.utils.graphs import GraphCache

    back = _port_backend(*jax_backend)
    cache = GraphCache("cpu")
    theta = run_benchmark.load_theta(back, "base", None)
    run_benchmark.generate_folder(back, theta, tmp_path / "a", batch_size=2, programs=cache)
    run_benchmark.generate_folder(back, theta, tmp_path / "b", batch_size=2, programs=cache, limit=2)
    assert sorted(cache.entries) == [("benchmark", 1), ("benchmark", 2)]


def test_score_folder_matches_jax(tmp_path, jax_backend):
    jback, prompts = jax_backend
    jrb.main([*TINY, "--prompts_txt", str(prompts), "--out_dir", str(tmp_path / "imgs"), "--batch_size", "2"])
    tsv = tmp_path / "parti.tsv"
    tsv.write_text(PARTI)
    common = ["--folder", str(tmp_path / "imgs"), "--parti_tsv", str(tsv), "--tiny_towers", "--image_size", "32",
              "--batch_size", "2"]
    theirs = jsf.main([*common, "--out_json", str(tmp_path / "j.json")])
    ours = score_folder.main([*common, "--out_json", str(tmp_path / "p.json"), "--device", "cpu"])
    assert sorted(ours) == sorted(theirs)
    assert "category/Abstract" in ours and "challenge/Imagination" in ours
    assert ours["num_images"] == theirs["num_images"] == 3
    err = max(abs(ours[g][k] - theirs[g][k]) for g in ours if g != "num_images" for k in theirs[g])
    assert err <= TOL, err
    saved = json.loads((tmp_path / "p.json").read_text())
    assert sorted(saved) == sorted(json.loads((tmp_path / "j.json").read_text()))
    assert all(sorted(saved[g]) == sorted(theirs[g]) for g in saved if g != "num_images")


def test_bundled_tsv_drives_the_eval_pipeline_as_jax(tmp_path):
    with TSV.open() as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    prompts = tmp_path / "p.txt"
    prompts.write_text("\n".join(r["Prompt"] for r in rows))
    gen = ["--backend", "sana_one_step", "--model_scale", "tiny", "--prompts_txt", str(prompts), "--batch_size", "4",
           "--lora_r", "2", "--limit", "4"]
    score = ["--parti_tsv", str(TSV), "--tiny_towers", "--image_size", "32", "--batch_size", "4"]
    jrb.main([*gen, "--out_dir", str(tmp_path / "jax")])
    theirs = jsf.main(["--folder", str(tmp_path / "jax"), *score])
    run_benchmark.main([*gen, "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    ours = score_folder.main(["--folder", str(tmp_path / "port"), *score, "--device", "cpu"])
    assert ours["num_images"] == theirs["num_images"] == 4
    groups = [g for g in theirs if g.startswith(("category/", "challenge/"))]
    assert groups and sorted(g for g in ours if g.startswith(("category/", "challenge/"))) == sorted(groups)
    err = max(abs(ours[g][k] - theirs[g][k]) for g in groups + ["overall"] for k in theirs[g])
    assert err <= TOL, err


def test_tp_outside_a_launch_of_its_size_raises_by_name(tmp_path):
    with pytest.raises(ValueError, match="--tp 2 shards the generator over a launch of 2 processes"):
        run_benchmark.main([*TINY, "--out_dir", str(tmp_path), "--device", "cpu", "--tp", "2"])
    assert not (tmp_path / "0000_a-red-cube.png").exists()


@pytest.mark.parametrize("entry", ["run_benchmark", "score_folder"])
def test_entry_points_need_a_card_or_the_cpu(tmp_path, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "0000_x.png").write_bytes(b"")
    argv = {"run_benchmark": [*TINY, "--out_dir", str(tmp_path / "o")],
            "score_folder": ["--folder", str(tmp_path), "--tiny_towers"]}[entry]
    main = {"run_benchmark": run_benchmark.main, "score_folder": score_folder.main}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_benchmark_runs_var_where_the_reference_raises(tmp_path):
    # the port fills the train CLI's backend flags; the reference's parser lacks --var_classes
    argv = ["--backend", "var", "--model_scale", "tiny", "--limit", "2", "--batch_size", "2"]
    with pytest.raises(AttributeError, match="var_classes"):
        jrb.main([*argv, "--out_dir", str(tmp_path / "jax")])
    paths = run_benchmark.main([*argv, "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert [p.name for p in paths] == ["0000_a-photo-of-class-0.png", "0001_a-photo-of-class-1.png"]
    assert all(read_png(p).shape[-1] == 3 for p in paths)
