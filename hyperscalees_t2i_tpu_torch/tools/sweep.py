"""Hyper-parameter sweep over the port's trainer (port of
``hyperscalees_t2i_tpu/tools/sweep.py``)::

    python -m hyperscalees_t2i_tpu_torch.tools.sweep \
        --grid '[{"sigma":1e-2,"lr_scale":1.0},{"sigma":3e-2,"lr_scale":0.5}]' \
        --run_dir runs/sweep1 -- \
        --backend sana_one_step --model_scale tiny --num_epochs 20 ...

Each config of the grid (σ, lr_scale, antithetic, pop_size, egg_rank,
num_epochs) runs ``train.cli.main`` into its own
``cfg{i}_sigma{σ:.0e}_lr{lr:.0e}_ant{a}`` directory; everything after
``--`` goes to the trainer verbatim for every config (``--device`` among
it). One ``sweep_summary.jsonl`` row a config, appended as it ends, and the
best config by its final ``summary_mean_reward``; a config that fails is
recorded and the sweep goes on.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List, Optional


def config_run_name(i: int, cfg: Dict[str, Any]) -> str:
    """The run name of config ``i``: cfg{i}_sigma{σ:.0e}_lr{lr:.0e}_ant{0|1}."""
    sigma = float(cfg.get("sigma", 1e-2))
    lr = float(cfg.get("lr_scale", 1.0))
    ant = int(bool(cfg.get("antithetic", True)))
    return f"cfg{i}_sigma{sigma:.0e}_lr{lr:.0e}_ant{ant}"


def run_sweep(grid: List[Dict[str, Any]], run_dir: Path, train_argv: List[str],
              train_main=None) -> List[Dict[str, Any]]:
    """Run every config; returns per-config summaries (best first)."""
    if train_main is None:
        from ..train.cli import main as train_main

    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    known = {"sigma", "lr_scale", "antithetic", "pop_size", "egg_rank", "num_epochs"}
    for i, cfg in enumerate(grid):
        unknown = set(cfg) - known
        if unknown:  # a typo'd key silently testing nothing would be worse
            raise SystemExit(
                f"config {i} has unknown grid keys {sorted(unknown)}; "
                f"supported: {sorted(known)}"
            )
    # fresh summary per sweep (incremental appends below stay crash-safe)
    (run_dir / "sweep_summary.jsonl").unlink(missing_ok=True)
    results = []
    for i, cfg in enumerate(grid):
        name = config_run_name(i, cfg)
        print(f"\n[sweep] ===== config {i}: {cfg} → {name} =====", flush=True)
        argv = list(train_argv) + [
            "--run_dir", str(run_dir), "--run_name", name,
            "--sigma", str(cfg.get("sigma", 1e-2)),
            "--lr_scale", str(cfg.get("lr_scale", 1.0)),
            "--antithetic", str(bool(cfg.get("antithetic", True))),
        ]
        for extra_key in ("pop_size", "egg_rank", "num_epochs"):
            if extra_key in cfg:
                argv += [f"--{extra_key}", str(cfg[extra_key])]
        summary: Dict[str, Any] = {"config_id": i, "run_name": name, **cfg}
        try:
            train_main(argv)
            summary.update(_read_outcome(run_dir / name))
        # SystemExit included: train.cli signals config-validation failures
        # via sys.exit, and argparse rejects bad grid values the same way —
        # one bad config must not kill the sweep
        except (Exception, SystemExit) as e:
            summary["error"] = f"{type(e).__name__}: {e}"[:300]
            print(f"[sweep] config {i} FAILED: {summary['error']}", flush=True)
        results.append(summary)
        with open(run_dir / "sweep_summary.jsonl", "a") as f:
            f.write(json.dumps(summary) + "\n")

    import math

    def _score(r):
        v = r.get("summary_mean_reward")
        if not isinstance(v, (int, float)) or math.isnan(v):
            return float("-inf")  # diverged (NaN) configs rank last, loudly
        return v

    ranked = sorted(results, key=_score, reverse=True)
    best = ranked[0] if ranked else None
    if best is not None and "error" not in best and _score(best) > float("-inf"):
        print(f"\n[sweep] BEST: {best['run_name']} "
              f"reward={best.get('summary_mean_reward')}", flush=True)
    elif ranked:
        print("\n[sweep] no config produced a final reward (check save_every "
              "and per-config errors in sweep_summary.jsonl)", flush=True)
    return ranked


def _read_outcome(cfg_dir: Path) -> Dict[str, Any]:
    meta = cfg_dir / "latest_meta.json"
    if meta.exists():
        m = json.loads(meta.read_text())
        return {
            "summary_mean_reward": m.get("summary_mean_reward"),
            "epoch": m.get("epoch"),
        }
    return {"summary_mean_reward": None, "epoch": None}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="ES hyperparameter sweep (PyTorch port)"
    )
    p.add_argument("--grid", required=True,
                   help="JSON list of configs (sigma, lr_scale, antithetic, "
                        "pop_size, egg_rank, num_epochs) or @file.json")
    p.add_argument("--run_dir", default="runs/sweep")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, train_argv = argv[:split], argv[split + 1:]
    else:
        train_argv = []
    args = build_parser().parse_args(argv)
    grid_src = args.grid
    if grid_src.startswith("@"):
        grid_src = Path(grid_src[1:]).read_text()
    grid = json.loads(grid_src)
    if not isinstance(grid, list) or not grid:
        raise SystemExit("--grid must be a non-empty JSON list of config objects")
    run_sweep(grid, Path(args.run_dir), train_argv)


if __name__ == "__main__":
    main()
