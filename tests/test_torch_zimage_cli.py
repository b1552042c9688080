"""``train.cli --backend zimage --model_scale tiny`` in the port against the
JAX CLI: the same command line (the dual adapter, ``--pop_fuse true
--base_quant int8`` at a 512-element floor so the tiny trees quantize),
two epochs from the seed alone in each package; every row key the port
writes is one the JAX CLI writes, and every shared non-clock value agrees
within 3e-4 (measured 4.1e-5), the checkpoint slot's θ too."""

import numpy as np
import torch

from hyperscalees_t2i_tpu.train import cli as jcli
from hyperscalees_t2i_tpu_torch.train import cli
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows

from test_torch_trainer import TOL, _assert_rows_match

torch.set_num_threads(1)


def test_zimage_cli_rows_match_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HSES_BASE_QUANT_MIN_SIZE", "512")
    prompts = tmp_path / "p.txt"
    prompts.write_text("a red square\na blue circle\na green cat\n")
    argv = ["--backend", "zimage", "--model_scale", "tiny", "--num_epochs", "2", "--pop_size", "4",
            "--prompts_per_gen", "2", "--member_batch", "2", "--save_every", "1", "--run_name", "cli",
            "--allow_random_rewards", "true", "--train_vae_decoder_lora", "true", "--pop_fuse", "true",
            "--base_quant", "int8", "--prompts_txt", str(prompts)]
    jcli.main(argv + ["--run_dir", str(tmp_path / "jax")])
    capsys.readouterr()
    assert cli.main(argv + ["--run_dir", str(tmp_path / "port"), "--device", "cpu"]) is None
    assert "training done at epoch 2" in capsys.readouterr().out
    jdir, pdir = tmp_path / "jax" / "cli", tmp_path / "port" / "cli"
    _assert_rows_match(read_jsonl_rows(jdir / "metrics.jsonl"), read_jsonl_rows(pdir / "metrics.jsonl"))
    slot = "ckpt/step_00000002/theta.npz"
    with np.load(jdir / slot) as jz, np.load(pdir / slot) as pz:
        assert set(jz.files) == set(pz.files) and any(k.startswith("vae_decoder") for k in pz.files)
        for k in jz.files:
            np.testing.assert_allclose(pz[k], jz[k], err_msg=k, **TOL)


def test_zimage_backend_builder_at_a_given_geometry(tmp_path, monkeypatch):
    """``cli.zimage_backend``, the builder behind ``--backend zimage`` at a
    geometry its caller gives (the full-width run on the card uses it),
    draws and quantizes as ``build_backend`` does at ``--model_scale
    tiny``: the same modules bitwise, int8 nodes among them, the prompt
    file read, the same backend config."""
    monkeypatch.setenv("HSES_BASE_QUANT_MIN_SIZE", "512")
    prompts = tmp_path / "p.txt"
    prompts.write_text("a red square\na blue circle\na green cat\n")
    args = cli.build_parser().parse_args([
        "--backend", "zimage", "--model_scale", "tiny", "--train_vae_decoder_lora", "true", "--base_quant", "int8",
        "--latent_size", "4", "--prompts_txt", str(prompts)])
    cpu = torch.device("cpu")
    ref = cli.build_backend(args, cpu)
    ref.setup()
    got = cli.zimage_backend(args, ref.cfg.model, ref.cfg.vae, cpu)
    got.setup()
    assert got.cfg == ref.cfg and got.prompts == ["a red square", "a blue circle", "a green cat"]
    for a, b in ((ref.model, got.model), (ref.vae, got.vae)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and any(t.dtype == torch.int8 for t in sb.values())
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
