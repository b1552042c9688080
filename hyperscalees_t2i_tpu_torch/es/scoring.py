"""Fitness shaping and prompt-normalized scoring (port of
``hyperscalees_t2i_tpu/es/scoring.py``).

- :func:`standardize_fitness` — ``(r − mean)/(std + 1e-8)`` with ddof 1;
- :func:`standardize_fitness_masked` — the same over finite members only,
  non-finite members get fitness 0;
- :func:`prompt_normalized_scores` — per-prompt means over the population,
  one global σ̄ (the RMS of every centered entry, ddof 0), z-scores
  averaged per member;
- :func:`jobwise_prompt_normalized_scores` — the same per job of a
  job-stacked ``[J, n, m]`` (fleet training).

The degenerate-spread guards are relative to the reward magnitude
(``std ≤ 1e-6·(1 + |scale|)``), so constant rewards give exactly zero
fitness whatever the rounding of the reductions.
"""

from __future__ import annotations

from typing import Tuple

import torch

_REL_TOL = 1e-6


def _degenerate(std: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return ~torch.isfinite(std) | (std <= _REL_TOL * (1.0 + scale))


def standardize_fitness(rewards: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(r − mean)/(std + eps) with ddof 1; all zeros on degenerate spread."""
    r = rewards.to(torch.float32)
    mean = r.mean()
    centered = r - mean
    n = r.shape[0]
    std = torch.sqrt((centered ** 2).sum() / max(n - 1, 1)) if n > 1 else torch.zeros((), device=r.device)
    bad = _degenerate(std, mean.abs())
    safe_std = torch.where(bad, torch.ones_like(std), std)
    return torch.where(bad, torch.zeros_like(r), centered / (safe_std + eps))


def standardize_fitness_masked(rewards: torch.Tensor, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standardize over finite entries only → ``(fitness, num_finite)``;
    non-finite members get 0, and with at most one finite member every
    fitness is 0 (the update is then a no-op)."""
    r = rewards.to(torch.float32)
    mask = torch.isfinite(r)
    n = mask.sum()
    safe_r = torch.where(mask, r, torch.zeros_like(r))
    mean = safe_r.sum() / n.clamp_min(1)
    centered = torch.where(mask, safe_r - mean, torch.zeros_like(r))
    std = torch.sqrt((centered ** 2).sum() / (n - 1).clamp_min(1))
    bad = (n <= 1) | _degenerate(std, mean.abs())
    safe_std = torch.where(bad, torch.ones_like(std), std)
    fit = torch.where(bad | ~mask, torch.zeros_like(r), centered / (safe_std + eps))
    return fit, n


def prompt_normalized_scores(S: torch.Tensor, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scores over ``S [n_pop, m_prompts]`` → ``(scores [n], mu_q [m],
    sigma_bar)``: ``scores_i = mean_j (S_ij − mu_qj)/σ̄`` with σ̄ the RMS of
    all centered entries, clamped to ``eps``; zero on a degenerate matrix."""
    if S.ndim != 2:
        raise ValueError(f"S must be [n, m], got {tuple(S.shape)}")
    S = S.to(torch.float32)
    mu_q = S.mean(dim=0)
    centered = S - mu_q[None, :]
    rms = torch.sqrt((centered ** 2).mean())
    bad = _degenerate(rms, S.abs().mean())
    sigma_bar = torch.where(bad, torch.ones_like(rms), rms).clamp_min(eps)
    scores = torch.where(bad, torch.zeros(S.shape[0], device=S.device), (centered / sigma_bar).mean(dim=1))
    return scores, mu_q, sigma_bar


def jobwise_prompt_normalized_scores(S: torch.Tensor, eps: float = 1e-8
                                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`prompt_normalized_scores` of each job of ``S [J, n, m]``,
    never pooled across jobs: job ``j``'s slice is exactly the solo call on
    ``S[j]``. Returns ``(scores [J, n], mu_q [J, m], sigma_bar [J])``."""
    if S.ndim != 3:
        raise ValueError(f"S must be [jobs, n, m], got {tuple(S.shape)}")
    per_job = [prompt_normalized_scores(s, eps) for s in S]
    return tuple(torch.stack([p[i] for p in per_job]) for i in range(3))
