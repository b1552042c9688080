"""Per-prompt reward attribution, the quality ledger and the
sample-efficiency artifact (port of ``hyperscalees_t2i_tpu/obs/quality.py``).

- :func:`quality_metrics` runs inside the ES step on the ``[pop, B]``
  reward rows it already holds: per unique prompt and per reward term, the
  population mean, the best member and the prompt's share of the
  promptnorm σ̄² mass. Tensors on the step's device; no host sync.
- :class:`QualityLedger` runs on the host once per logged epoch over the
  fetched scalars: one row per epoch in ``run_dir/quality.jsonl`` with the
  hardest prompts, the reward-hacking detector (a term falling for
  ``hack_window`` consecutive epochs while ``combined`` rises → a stderr
  ALERT and ``quality/hack_suspect``), and the scalar ``quality/*`` gauges.
- :func:`build_quality_artifact` folds a finished run dir into the
  ``QUALITY_*.json`` payload: the combined-reward curve against cumulative
  images and device seconds (from the run's ``CALIB*.json`` where a profile
  window took one, ``obs/calib.py``; else the host's ``step_time_s``), the
  final reward, the AUC over images, images to threshold and the reward
  gain per device second. ``run_training`` writes ``QUALITY_train.json``
  at the run's end.

CLI::

    python -m hyperscalees_t2i_tpu_torch.obs.quality RUN_DIR [--out PATH]
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

QUALITY_SCHEMA_VERSION = 1
QUALITY_LEDGER = "quality.jsonl"
DEFAULT_REWARD_KEYS = ("clip_aesthetic", "clip_text", "no_artifacts", "pickscore", "combined")
_EPS = 1e-12


def quality_metrics(rewards: Mapping[str, Any], *, pop: int, num_unique: int, repeats: int,
                    reward_keys: Sequence[str] = DEFAULT_REWARD_KEYS) -> Dict[str, Any]:
    """For each term ``k`` of ``rewards`` (``[pop, B]``, ``B = repeats ·
    num_unique`` in the grouped layout ``[r][m]``), three ``[m]`` vectors:
    ``quality/<k>/prompt_mean`` (mean over finite members; 0 when none),
    ``quality/<k>/prompt_best`` (best finite member; 0 when none) and
    ``quality/<k>/sigma_share`` (the prompt's centered mean square over the
    total). NaN members are masked out, repeats by repeats."""
    import torch

    out: Dict[str, Any] = {}
    for k in reward_keys:
        if k not in rewards:
            continue
        rk = rewards[k].to(torch.float32).reshape(pop, repeats, num_unique)
        rmask = torch.isfinite(rk)
        n_rep = rmask.sum(dim=1).clamp_min(1)
        zero = torch.zeros((), device=rk.device)
        S = torch.where(rmask, rk, zero).sum(dim=1) / n_rep  # [pop, m]
        mask = rmask.any(dim=1)
        n = mask.sum(dim=0).clamp_min(1)
        mean = torch.where(mask, S, zero).sum(dim=0) / n  # [m]
        best = torch.where(mask.any(dim=0), torch.where(mask, S, torch.full_like(S, -math.inf)).amax(dim=0), zero)
        centered = torch.where(mask, S - mean[None, :], zero)
        ms = (centered ** 2).sum(dim=0) / n
        share = ms / ms.sum().clamp_min(_EPS)
        out[f"quality/{k}/prompt_mean"] = mean
        out[f"quality/{k}/prompt_best"] = best
        out[f"quality/{k}/sigma_share"] = share
    return out


def _finite(v: Any) -> Optional[float]:
    if isinstance(v, (int, float)) and math.isfinite(float(v)):
        return float(v)
    return None


class QualityLedger:
    """One host-side tick per logged epoch, appending to
    ``run_dir/quality.jsonl``."""

    def __init__(self, run_dir: Union[str, Path], *,
                 reward_keys: Sequence[str] = DEFAULT_REWARD_KEYS, hack_window: int = 4, top_k: int = 5):
        self.path = Path(run_dir) / QUALITY_LEDGER
        self.reward_keys = tuple(reward_keys)
        self.hack_window = int(hack_window)
        self.top_k = int(top_k)
        self.images_cum = 0.0
        self._prev: Dict[str, float] = {}
        self._streak: Dict[str, int] = {}
        self._fired: Dict[str, bool] = {}
        self.alerts = 0

    def _detect(self, terms: Dict[str, float], epoch: int) -> Dict[str, int]:
        combined = terms.get("combined")
        prev_combined = self._prev.get("combined")
        streaks: Dict[str, int] = {}
        for k, v in terms.items():
            if k == "combined":
                continue
            prev = self._prev.get(k)
            rising = combined is not None and prev_combined is not None and combined > prev_combined + _EPS
            falling = prev is not None and v < prev - _EPS
            if rising and falling:
                self._streak[k] = self._streak.get(k, 0) + 1
                if self.hack_window > 0 and self._streak[k] >= self.hack_window and not self._fired.get(k):
                    self._fired[k] = True
                    self.alerts += 1
                    print(f"[quality] ALERT: reward term '{k}' fell for {self._streak[k]} consecutive logged "
                          f"generations while 'combined' rose (epoch {epoch}) — possible reward hacking: the "
                          "optimizer is trading this head against the mix (see quality.jsonl)",
                          file=sys.stderr, flush=True)
            else:
                self._streak[k] = 0
                self._fired[k] = False
            streaks[k] = self._streak.get(k, 0)
        self._prev = dict(terms)
        return streaks

    def observe(self, epoch: int, scalars: Mapping[str, Any]) -> Dict[str, float]:
        """Feed one epoch's scalars (vectors already lists). Returns the
        gauges to merge into the row; malformed inputs give absent gauges,
        never an exception."""
        self.images_cum += _finite(scalars.get("images_scored")) or 0.0
        terms = {}
        for k in self.reward_keys:
            v = _finite(scalars.get(f"reward/{k}_mean"))
            if v is not None:
                terms[k] = v
        streaks = self._detect(terms, epoch)

        prompts = scalars.get("prompts")
        prompts = prompts if isinstance(prompts, (list, tuple)) else None
        pm = scalars.get("quality/combined/prompt_mean")
        if not isinstance(pm, (list, tuple)):
            pm = scalars.get("per_prompt_mean")
        hardest: List[Dict[str, Any]] = []
        if isinstance(pm, (list, tuple)) and pm:
            ranked = sorted((v, j) for v, j in ((_finite(v), j) for j, v in enumerate(pm)) if v is not None)
            for v, j in ranked[: self.top_k]:
                row: Dict[str, Any] = {"idx": j, "mean": v}
                if prompts is not None and j < len(prompts):
                    row["prompt"] = str(prompts[j])
                hardest.append(row)

        gauges: Dict[str, float] = {
            "quality/images_cum": float(self.images_cum),
            "quality/hack_suspect": 1.0 if any(self._fired.values()) else 0.0,
            "quality/hack_streak_max": float(max(streaks.values(), default=0)),
            "quality/hack_alerts": float(self.alerts),
        }
        if hardest:
            gauges["quality/hardest_prompt_idx"] = float(hardest[0]["idx"])
            gauges["quality/hardest_prompt_mean"] = float(hardest[0]["mean"])

        row = {"epoch": int(epoch), "ts": time.time(), "images_cum": self.images_cum, "reward": terms,
               "hardest": hardest, "hack_streaks": {k: v for k, v in streaks.items() if v}}
        for key in (f"quality/{k}/{stat}" for k in self.reward_keys
                    for stat in ("prompt_mean", "prompt_best", "sigma_share")):
            v = scalars.get(key)
            if isinstance(v, (list, tuple)):
                row[key] = list(v)
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with self.path.open("a") as f:
                f.write(json.dumps(row) + "\n")
        except OSError as e:
            print(f"[quality] WARNING: ledger append failed ({e!r})", file=sys.stderr, flush=True)
        return gauges


# ---------------------------------------------------------------------------
# the sample-efficiency artifact (QUALITY_*.json)
# ---------------------------------------------------------------------------

def _fold_metrics(run_dir: Path) -> List[Dict[str, Any]]:
    """metrics.jsonl rows folded by epoch, the last occurrence winning (a
    resumed run's replay supersedes): the run's final trajectory."""
    from ..utils.jsonl import read_jsonl_rows

    by_epoch: Dict[int, Dict[str, Any]] = {}
    for r in read_jsonl_rows(run_dir / "metrics.jsonl"):
        try:
            ep = int(r["epoch"])
        except (KeyError, TypeError, ValueError):
            continue
        by_epoch[ep] = r
    return [by_epoch[e] for e in sorted(by_epoch)]


def _device_seconds_per_epoch(run_dir: Path) -> Tuple[Optional[float], str]:
    """Per-epoch device seconds from the run's ``CALIB*.json`` training rows
    (their median), else ``(None, "host_wall")``: the caller then uses
    ``step_time_s``."""
    from .calib import load_calib

    vals: List[float] = []
    for cp in sorted(run_dir.glob("CALIB*.json")):
        doc = load_calib(cp)
        if not isinstance(doc, dict) or doc.get("mode") != "calib":
            continue
        for row in doc.get("rows") or []:
            if not isinstance(row, dict):
                continue
            key = str(row.get("key", ""))
            v = row.get("measured_s")
            if key.startswith("train/") and isinstance(v, (int, float)) and v > 0:
                chain = row.get("chain")  # a chained program measures the whole chain
                vals.append(float(v) / float(chain) if isinstance(chain, (int, float)) and chain else float(v))
    if not vals:
        return None, "host_wall"
    vals.sort()
    return vals[len(vals) // 2], "calib"


def _ledger_chip_kind(path: Path) -> Optional[str]:
    """The ledger's dominant ``device_kind``: one vote per (metric, program)
    of the last record of each program with that metric positive."""
    from .program_cost import load_programs

    last: Dict[Tuple[str, str], Optional[str]] = {}
    for r in load_programs(path):
        if not r.get("label"):
            continue
        for metric in ("bytes_accessed", "flops", "peak_bytes", "compile_s"):
            v = r.get(metric)
            if isinstance(v, (int, float)) and v > 0:
                last[(metric, f"{r.get('site', '?')}/{r['label']}")] = r.get("device_kind") or None
    chips = [c for c in last.values() if c]
    return max(set(chips), key=chips.count) if chips else None


def build_quality_artifact(
    run_dir: Union[str, Path],
    *,
    threshold_frac: float = 0.9,
    reward_keys: Sequence[str] = DEFAULT_REWARD_KEYS,
) -> Dict[str, Any]:
    """The sample-efficiency payload of a finished run dir.

    Curve: per logged epoch the combined reward against cumulative images
    and cumulative device seconds (``device_s_source``: ``"calib"`` or
    ``"host_wall"``). Summaries: ``final_reward``; ``auc_over_images``
    (the trapezoid AUC over the images axis over the image span);
    ``images_to_threshold`` (first cumulative count at which the reward
    reached ``first + threshold_frac·(final − first)``, null when the run
    never improved); ``reward_per_device_s`` (``(final − first) /
    device_s_total``)."""
    run_dir = Path(run_dir)
    rows = _fold_metrics(run_dir)
    dev_per_epoch, dev_source = _device_seconds_per_epoch(run_dir)

    def _r6(v: float) -> float:
        return round(float(v), 6)

    curve: List[Dict[str, Any]] = []
    images = 0.0
    device_s = 0.0
    per_term_final: Dict[str, float] = {}
    for r in rows:
        combined = _finite(r.get("reward/combined_mean"))
        if combined is None:
            combined = _finite(r.get("opt_score_mean"))
        if combined is None:
            continue
        chained = _finite(r.get("epochs_chained")) or 1.0
        images += (_finite(r.get("images_scored")) or 0.0)
        step_s = _finite(r.get("step_time_s")) or 0.0
        device_s += dev_per_epoch * chained if dev_per_epoch is not None else step_s * chained
        curve.append({"epoch": int(r["epoch"]), "images_cum": images, "device_s_cum": _r6(device_s),
                      "combined": _r6(combined)})
        for k in reward_keys:
            v = _finite(r.get(f"reward/{k}_mean"))
            if v is not None:
                per_term_final[k] = _r6(v)

    payload: Dict[str, Any] = {
        "mode": "quality",
        "schema_version": QUALITY_SCHEMA_VERSION,
        "run_dir": str(run_dir),
        "epochs": len(curve),
        "images_total": images,
        "device_s_total": _r6(device_s),
        "device_s_source": dev_source,
        "threshold_frac": threshold_frac,
        "per_term_final": per_term_final,
        "curve": curve,
    }
    try:
        import torch

        payload["torch_version"] = str(torch.__version__)
    except Exception:
        payload["torch_version"] = None
    try:
        payload["chip_kind"] = _ledger_chip_kind(run_dir / "programs.jsonl")
    except Exception:
        payload["chip_kind"] = None

    if curve:
        first = curve[0]["combined"]
        final = curve[-1]["combined"]
        payload["first_reward"] = first
        payload["final_reward"] = final
        span = curve[-1]["images_cum"] - curve[0]["images_cum"]
        if span > 0:
            auc = 0.0
            for a, b in zip(curve, curve[1:]):
                auc += 0.5 * (a["combined"] + b["combined"]) * (b["images_cum"] - a["images_cum"])
            payload["auc_over_images"] = _r6(auc / span)
        else:
            payload["auc_over_images"] = final
        threshold = _r6(first + threshold_frac * (final - first))
        payload["threshold"] = threshold
        payload["images_to_threshold"] = (next((c["images_cum"] for c in curve if c["combined"] >= threshold), None)
                                          if final > first else None)
        payload["reward_per_device_s"] = _r6((final - first) / device_s) if device_s > 0 else None

    ledger = run_dir / QUALITY_LEDGER
    if ledger.exists():  # the hardest prompts at the run's end
        try:
            from ..utils.jsonl import read_jsonl_rows

            lrows = read_jsonl_rows(ledger)
            if lrows:
                payload["hardest_prompts"] = lrows[-1].get("hardest") or []
        except Exception:
            pass
    return payload


def write_quality(payload: Mapping[str, Any], out: Union[str, Path]) -> Path:
    import os

    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".tmp")
    tmp.write_text(json.dumps(payload, indent=2) + "\n")
    os.replace(tmp, out)
    return out


def load_quality(path: Union[str, Path]) -> Optional[Dict[str, Any]]:
    """A quality artifact document (a ``{"parsed": {...}}`` wrapper
    unwrapped), or None when the file is not one."""
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(doc, dict):
        return None
    if doc.get("mode") != "quality":
        doc = doc.get("parsed") or {}
        if not isinstance(doc, dict) or doc.get("mode") != "quality":
            return None
    return doc


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="build the QUALITY_* sample-efficiency artifact from a finished run dir")
    ap.add_argument("run_dir", help="run dir containing metrics.jsonl")
    ap.add_argument("--out", default=None, help="artifact path (default: <run_dir>/QUALITY_run.json)")
    ap.add_argument("--threshold_frac", type=float, default=0.9,
                    help="images-to-threshold target as a fraction of the first→final reward gain (default 0.9)")
    args = ap.parse_args(argv)
    run_dir = Path(args.run_dir)
    if not (run_dir / "metrics.jsonl").exists():
        print(f"no metrics.jsonl in {run_dir}", file=sys.stderr)
        return 1
    payload = build_quality_artifact(run_dir, threshold_frac=args.threshold_frac)
    if not payload["curve"]:
        print(f"no reward curve in {run_dir}/metrics.jsonl", file=sys.stderr)
        return 1
    out = Path(args.out) if args.out else run_dir / "QUALITY_run.json"
    write_quality(payload, out)
    print(f"quality artifact → {out} ({payload['epochs']} epoch(s), final reward {payload.get('final_reward'):.6g}, "
          f"{payload['images_total']:.0f} images, device-s source {payload['device_s_source']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
