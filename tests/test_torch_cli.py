"""The port's train CLI (``python -m hyperscalees_t2i_tpu_torch.train.cli``)
against the JAX CLI's parser, and end to end on the CPU at the tiny
geometry."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hyperscalees_t2i_tpu.train.cli import build_parser as jbuild_parser
from hyperscalees_t2i_tpu_torch.resilience.checkpoints import CheckpointStore
from hyperscalees_t2i_tpu_torch.train import cli
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TINY = ["--model_scale", "tiny", "--device", "cpu", "--num_epochs", "2", "--allow_random_rewards", "true",
        "--pop_size", "4", "--prompts_per_gen", "2", "--save_every", "1", "--run_name", "cli"]


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_defaults_match_jax():
    ours, theirs = _actions(cli.build_parser()), _actions(jbuild_parser())
    assert set(ours) - set(theirs) == {"device"}
    for dest, a in ours.items():
        if dest == "device":
            assert a.default is None
            continue
        assert a.default == theirs[dest].default, dest
        assert a.required == theirs[dest].required, dest
        if a.choices is not None:
            assert set(a.choices) <= set(theirs[dest].choices), dest
    # parsed values for a shared command line agree too
    argv = ["--backend", "var", "--sigma", "0.02", "--antithetic", "false", "--resume", "auto", "--trace"]
    a, b = vars(cli.build_parser().parse_args(argv)), vars(jbuild_parser().parse_args(argv))
    assert all(a[k] == b[k] for k in a if k != "device")


def test_train_config_from_the_command_line():
    args = cli.build_parser().parse_args(["--backend", "sana_one_step", "--noise_dtype", "bf16", "--w_pick", "0.1"])
    tc = cli.train_config(args)
    assert tc.noise_dtype == "bfloat16" and tc.reward_weights == (0.3, 0.3, 0.2, 0.1)
    assert dataclasses.replace(tc, noise_dtype="float32", reward_weights=(0.3, 0.3, 0.2, 0.2),
                               run_dir="runs/default") == TrainConfig()


@pytest.mark.parametrize("backend", ["sana_one_step", "sana_pipeline", "var"])
def test_tiny_run_through_main(tmp_path, backend, capsys):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("# a comment\na red square\n\na blue circle\na green cat\n")
    # a finished run returns from main, so the interpreter exits 0
    assert cli.main(["--backend", backend, "--run_dir", str(tmp_path), "--prompts_txt", str(prompts), *TINY]) is None
    run_dir = tmp_path / "cli"
    rows = read_jsonl_rows(run_dir / "metrics.jsonl")
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all(len(r["quality/combined/prompt_mean"]) == 2 for r in rows)
    assert [p.name for p in CheckpointStore(run_dir).slots()] == ["step_00000001", "step_00000002"]
    assert "training done at epoch 2" in capsys.readouterr().out


def test_halt_exits_3(tmp_path):
    # every θ exceeds the explode norm: the first epoch trips with no slot to restore
    with pytest.raises(SystemExit) as done:
        cli.main(["--backend", "sana_one_step", "--run_dir", str(tmp_path), *TINY, "--theta_explode_norm", "1e-9"])
    assert done.value.code == 3
    assert (tmp_path / "cli" / "halted.json").exists()


def test_weights_raise(tmp_path, capsys):
    """``--weights`` trains from a diffusers-layout Sana checkpoint (a bf16
    safetensors file from ``chip_smoke.py``'s writer, at a width that keeps
    the default head counts whole) with the JAX converter's tree as the
    backend's; the Sana ``--vae_weights`` refusal (no DC-AE converter, as in
    the JAX CLI) and ``--backend zimage`` (ROADMAP queue A item 9) stand."""
    from hyperscalees_t2i_tpu.weights.io import load_state_dict as jload
    from hyperscalees_t2i_tpu.weights.sana import convert_sana_transformer as jconvert, infer_sana_config as jinfer
    from hyperscalees_t2i_tpu_torch.models import sana

    from test_torch_weights_var import assert_trees_bitwise
    from test_torch_weights_writers import SANA, cs

    path = tmp_path / "diffusion_pytorch_model.safetensors"
    cs.write_released_safetensors(path, cs.released_sana_keys(sana.SanaConfig(**SANA)), seed=0)
    argv = ["--backend", "sana_one_step", "--weights", str(path), "--run_dir", str(tmp_path), *TINY]
    backend = cli.build_backend(cli.build_parser().parse_args(argv), torch.device("cpu"))
    sd = jload(str(path))
    assert_trees_bitwise(backend._params, jconvert(sd, jinfer(sd)))
    assert cli.main(argv) is None
    out = capsys.readouterr().out
    assert "loaded sana weights: 2L d=140 caption=8" in out and "training done at epoch 2" in out
    assert len(read_jsonl_rows(tmp_path / "cli" / "metrics.jsonl")) == 2
    with pytest.raises(SystemExit, match="DC-AE"):
        cli.main(argv + ["--vae_weights", "vae.pth"])
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        cli.main(["--backend", "zimage", "--weights", "z.gguf", *TINY])


def test_entry_point_needs_a_card_or_the_cpu(tmp_path):
    out = subprocess.run([sys.executable, "-m", "hyperscalees_t2i_tpu_torch.train.cli", "--backend", "sana_one_step",
                          "--model_scale", "tiny", "--num_epochs", "1", "--run_dir", str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert not (tmp_path / "runs").exists() and not list(tmp_path.iterdir())
