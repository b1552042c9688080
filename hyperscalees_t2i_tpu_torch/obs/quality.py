"""Per-prompt reward attribution and the quality ledger (port of
``quality_metrics`` and ``QualityLedger`` from
``hyperscalees_t2i_tpu/obs/quality.py``; the sample-efficiency artifact
``build_quality_artifact`` comes with the tools).

- :func:`quality_metrics` runs inside the ES step on the ``[pop, B]``
  reward rows it already holds: per unique prompt and per reward term, the
  population mean, the best member and the prompt's share of the
  promptnorm σ̄² mass. Tensors on the step's device; no host sync.
- :class:`QualityLedger` runs on the host once per logged epoch over the
  fetched scalars: one row per epoch in ``run_dir/quality.jsonl`` with the
  hardest prompts, the reward-hacking detector (a term falling for
  ``hack_window`` consecutive epochs while ``combined`` rises → a stderr
  ALERT and ``quality/hack_suspect``), and the scalar ``quality/*`` gauges.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

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
