"""The port's sweep tool (``tools/sweep.py``) against the JAX package's on
the CPU.

- ``config_run_name``: equal to the reference's on each config.
- ``run_sweep`` with a recording ``train_main``: the same per-config argv,
  summary rows and ranking as the reference's, a failing config (an
  exception, or the trainer's ``SystemExit``) recorded and survived.
- One two-config, one-epoch sweep at the tiny rung end to end through the
  port's ``train.cli.main`` on the CPU (≈ 10 s).
"""

import json

import pytest
import torch

from hyperscalees_t2i_tpu.tools import sweep as jsweep
from hyperscalees_t2i_tpu_torch.tools import sweep

torch.set_num_threads(1)


@pytest.mark.parametrize("i,cfg", [
    (0, {"sigma": 1e-2, "lr_scale": 1.0, "antithetic": True}),
    (3, {"sigma": 3e-3, "lr_scale": 0.5, "antithetic": False}),
    (7, {}),
    (12, {"sigma": 0.05, "num_epochs": 1, "pop_size": 16}),
    (1, {"sigma": "2e-2", "lr_scale": "3", "antithetic": 0}),
])
def test_config_run_name_matches_reference(i, cfg):
    assert sweep.config_run_name(i, cfg) == jsweep.config_run_name(i, cfg)


def _recording_trainer(root, calls, fail_at):
    def train(argv):
        calls.append(list(argv))
        i = len(calls) - 1
        if i in fail_at:
            raise fail_at[i]
        name = argv[argv.index("--run_name") + 1]
        d = root / name
        d.mkdir(parents=True)
        reward = float("nan") if i == 3 else float(i)
        (d / "latest_meta.json").write_text(json.dumps({"summary_mean_reward": reward, "epoch": 2}))

    return train


def test_run_sweep_matches_reference(tmp_path):
    grid = [{"sigma": 1e-2}, {"sigma": 2e-2, "lr_scale": 0.5}, {"sigma": 3e-2, "antithetic": False, "pop_size": 4},
            {"sigma": 4e-2, "egg_rank": 2}, {"sigma": 5e-2, "num_epochs": 3}]
    out = {}
    for tag, mod in (("port", sweep), ("jax", jsweep)):
        root, calls = tmp_path / tag, []
        fail_at = {1: RuntimeError("boom"), 4: SystemExit("ERROR: bad config")}
        ranked = mod.run_sweep(grid, root, ["--backend", "x"], train_main=_recording_trainer(root, calls, fail_at))
        rows = [json.loads(l) for l in (root / "sweep_summary.jsonl").read_text().splitlines()]
        out[tag] = (calls, ranked, rows)
    (calls, ranked, rows), (jcalls, jranked, jrows) = out["port"], out["jax"]
    rel = lambda argv, tag: [a.replace(f"/{tag}", "/X") for a in argv]  # noqa: E731
    assert [rel(c, "port") for c in calls] == [rel(c, "jax") for c in jcalls]
    assert json.dumps(ranked, sort_keys=True) == json.dumps(jranked, sort_keys=True)
    assert [r["config_id"] for r in ranked] == [r["config_id"] for r in jranked] == [2, 0, 1, 3, 4]
    assert [r.get("error") for r in rows] == [r.get("error") for r in jrows]
    assert rows[1]["error"] == "RuntimeError: boom" and rows[4]["error"].startswith("SystemExit")
    assert calls[2][calls[2].index("--antithetic") + 1] == "False" and "--pop_size" in calls[2]


def test_unknown_grid_keys_and_an_empty_grid_refuse(tmp_path):
    with pytest.raises(SystemExit, match="unknown grid keys"):
        sweep.run_sweep([{"sigma": 1e-2, "sigmaa": 2}], tmp_path, [], train_main=lambda argv: None)
    with pytest.raises(SystemExit, match="non-empty JSON list"):
        sweep.main(["--grid", "[]", "--run_dir", str(tmp_path)])


def test_sweep_end_to_end_tiny(tmp_path):
    prompts = tmp_path / "p.txt"
    prompts.write_text("a red cube\na blue sphere\n")
    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps([{"sigma": 0.05, "num_epochs": 1}, {"sigma": 0.01, "num_epochs": 1}]))
    sweep.main([
        "--grid", f"@{grid}", "--run_dir", str(tmp_path / "sweep"), "--",
        "--backend", "sana_one_step", "--model_scale", "tiny", "--device", "cpu", "--prompts_txt", str(prompts),
        "--lora_r", "2", "--pop_size", "4", "--prompts_per_gen", "2", "--save_every", "1",
    ])
    recs = [json.loads(l) for l in (tmp_path / "sweep" / "sweep_summary.jsonl").read_text().splitlines()]
    assert [r["run_name"] for r in recs] == ["cfg0_sigma5e-02_lr1e+00_ant1", "cfg1_sigma1e-02_lr1e+00_ant1"]
    assert all("error" not in r and isinstance(r["summary_mean_reward"], float) and r["epoch"] == 1 for r in recs)
    assert (tmp_path / "sweep" / "cfg0_sigma5e-02_lr1e+00_ant1" / "latest_theta.npz").exists()
