"""The port's ``weights.validate`` against the JAX package's: the JAX
``validate --write_expected`` on tiny VAR, Sana and Infinity checkpoints,
then the port's ``validate --expect`` on the same files, which must pass at
``DEFAULT_ATOL`` (5e-3). Sana and Infinity run the inferred geometry's
bf16 compute on the CPU; VAR runs in f32 on both sides, because at bf16
the two frameworks' top-k/top-p samplers draw different tokens from the
tiny random model's near-flat logits (the first image's ``grid8`` then
differs by 0.12, ROADMAP queue C: no bitwise claims across frameworks).
The largest stat difference measured: VAR 1.0e-6, Sana 1.3e-3,
Infinity 1.1e-3. A perturbed checkpoint fails the port's ``--expect``.

The reference's ``--family sana`` hands ``--backend sana`` to its train
CLI, whose parser refuses it (exit 2, a fault of the reference, ROADMAP
queue C); its stats are written here through the JAX ``generation_stats``
with the family's backend named ``sana_one_step``, which is what the port
builds for ``--family sana``."""

import json

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.weights import validate as jvalidate
from hyperscalees_t2i_tpu_torch.models import sana
from hyperscalees_t2i_tpu_torch.weights import validate

import test_weights_infinity as twi
from test_torch_weights_var import write_canonical_var
from test_torch_weights_writers import SANA, cs

torch.set_num_threads(1)


def _sana_checkpoint(tmp_path):
    path = tmp_path / "diffusion_pytorch_model.safetensors"
    cs.write_released_safetensors(path, cs.released_sana_keys(sana.SanaConfig(**SANA)), seed=4)
    (tmp_path / "p.txt").write_text("a red square\na blue circle\n")
    return ["--family", "sana", "--weights", str(path), "--model_scale", "tiny", "--prompts_txt",
            str(tmp_path / "p.txt"), "--images", "2"]


def _var_checkpoint(tmp_path):
    ckpt, vae = write_canonical_var(tmp_path, seed=5)
    return ["--family", "var", "--weights", str(ckpt), "--vae_weights", str(vae), "--images", "2"]


def _infinity_checkpoint(tmp_path):
    ckpt = tmp_path / "infinity.pt"
    sd = twi.make_sd(np.random.default_rng(21), qk_l2=True)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    (tmp_path / "p.txt").write_text("a red square\na blue circle\n")
    return ["--family", "infinity", "--weights", str(ckpt), "--prompts_txt", str(tmp_path / "p.txt"),
            "--images", "2"]


CHECKPOINTS = {"sana": _sana_checkpoint, "var": _var_checkpoint, "infinity": _infinity_checkpoint}


def _jax_write_expected(monkeypatch, argv, path):
    if argv[1] == "sana":
        real = jvalidate._build_backend

        def one_step(args):
            import copy

            args = copy.copy(args)
            args.family = "sana_one_step"
            return real(args)

        monkeypatch.setattr(jvalidate, "_build_backend", one_step)
    assert jvalidate.main(argv + ["--write_expected", str(path)]) == 0


def _var_in_f32(monkeypatch):
    """Both packages' VAR inference with the transformer and the VQ-VAE in f32."""
    import dataclasses

    import hyperscalees_t2i_tpu.weights as jweights
    import jax.numpy as jnp

    from hyperscalees_t2i_tpu_torch.weights import var as pvar

    for mod, dt in ((jweights, jnp.float32), (pvar, torch.float32)):
        real = mod.infer_var_config

        def f32(sd, real=real, dt=dt, **kw):
            cfg = real(sd, **kw)
            return dataclasses.replace(cfg, compute_dtype=dt, vq=dataclasses.replace(cfg.vq, compute_dtype=dt))

        monkeypatch.setattr(mod, "infer_var_config", f32)


@pytest.mark.parametrize("family", sorted(CHECKPOINTS))
def test_jax_stats_pass_the_ports_expect(tmp_path, monkeypatch, capsys, family):
    argv = CHECKPOINTS[family](tmp_path)
    if family == "var":
        _var_in_f32(monkeypatch)
    expected = tmp_path / "expected.json"
    _jax_write_expected(monkeypatch, argv, expected)
    want = json.loads(expected.read_text())
    assert want["family"] == family and want["images"] == 2
    capsys.readouterr()
    assert validate.main(argv + ["--device", "cpu", "--expect", str(expected)]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["shape"] == want["shape"] and got["checkpoint"] == want["checkpoint"]
    worst = max(float(np.max(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64))))
                for k in ("mean", "std", "min", "max", "grid8"))
    assert worst <= validate.DEFAULT_ATOL == jvalidate.DEFAULT_ATOL


def test_a_perturbed_checkpoint_fails_the_ports_expect(tmp_path):
    argv = _infinity_checkpoint(tmp_path) + ["--device", "cpu"]
    expected = tmp_path / "expected.json"
    assert validate.main(argv + ["--write_expected", str(expected)]) == 0
    assert validate.main(argv + ["--expect", str(expected)]) == 0
    sd = twi.make_sd(np.random.default_rng(21), qk_l2=True)
    sd["head.weight"] = sd["head.weight"] * 3.0  # scales the logit margins, so sampled bits flip
    sd["word_embed.weight"] = sd["word_embed.weight"] * 0.5
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "infinity.pt")
    assert validate.main(argv + ["--expect", str(expected)]) == 1


def test_the_references_sana_family_is_refused_by_its_parser(tmp_path):
    with pytest.raises(SystemExit) as done:
        jvalidate.main(_sana_checkpoint(tmp_path))
    assert done.value.code == 2


def test_compare_stats_matches_jax():
    got = {"family": "sana", "images": 2, "shape": [8, 8, 3], "seed": 0, "mean": [0.5, 0.6], "std": [0.1, 0.2],
           "min": 0.0, "max": 1.0, "grid8": [[0.5] * 8] * 8}
    cases = [dict(got), dict(got, mean=[0.5004, 0.6004]), dict(got, mean=[0.9, 0.6]), dict(got, family="var"),
             dict(got, grid8=[[0.5] * 4] * 8), {k: v for k, v in got.items() if k != "grid8"}]
    for want in cases:
        assert validate.compare_stats(got, want, 5e-3) == jvalidate.compare_stats(got, want, 5e-3)
    assert validate.compare_stats(got, cases[1], 5e-3) == [] and validate.compare_stats(got, cases[2], 5e-3)
