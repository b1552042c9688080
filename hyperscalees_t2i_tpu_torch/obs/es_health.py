"""ES-semantic health diagnostics computed inside the ES step (port of the
in-step functions of ``hyperscalees_t2i_tpu/obs/es_health.py``).

Metric names (``es/`` prefix), as the JAX package writes them:
``es/reward_mean|std|min|max`` and ``es/finite_frac`` over finite members,
``es/fitness_zero`` (the update was a no-op), ``es/update_cosine``
(cos(Δθ_t, Δθ_{t−1}), 0 without a previous update), ``es/cap_theta_scale``
and ``es/cap_step_scale``, ``es/pair_asym`` (antithetic pair asymmetry) and
``es/leaf_delta_norm/<target>`` per LoRA target. Every value stays a tensor
on the step's device; nothing here syncs with the host, except
:class:`DegeneracyWatchdog`, which the training loop feeds the fetched
``es/fitness_zero`` once an epoch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..utils.pytree import tree_leaves, tree_leaves_with_path

_EPS = 1e-12


def masked_reward_stats(opt_scores: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mean/std (ddof 1)/min/max of the per-member scores over finite
    members, and the finite fraction; 0-stats when none is finite."""
    r = opt_scores.to(torch.float32)
    mask = torch.isfinite(r)
    n = mask.sum()
    zero = torch.zeros((), device=r.device)
    safe_r = torch.where(mask, r, zero)
    mean = safe_r.sum() / n.clamp_min(1)
    centered = torch.where(mask, safe_r - mean, zero)
    std = torch.sqrt((centered ** 2).sum() / (n - 1).clamp_min(1))
    rmin = torch.where(mask, r, torch.full_like(r, float("inf"))).min()
    rmax = torch.where(mask, r, torch.full_like(r, float("-inf"))).max()
    any_finite = n > 0
    return {
        "es/reward_mean": torch.where(any_finite, mean, zero),
        "es/reward_std": torch.where(any_finite, std, zero),
        "es/reward_min": torch.where(any_finite, rmin, zero),
        "es/reward_max": torch.where(any_finite, rmax, zero),
        "es/finite_frac": n.to(torch.float32) / opt_scores.shape[0],
    }


def tree_dot(a: Any, b: Any) -> torch.Tensor:
    """Global f32 inner product over two trees of the same structure."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if not la:
        return torch.zeros(())
    return sum((x.to(torch.float32) * y.to(torch.float32)).sum() for x, y in zip(la, lb))


def update_cosine(delta: Any, prev_delta: Any) -> torch.Tensor:
    """cos(Δθ_t, Δθ_{t−1}); 0 when either update is (numerically) zero."""
    dot = tree_dot(delta, prev_delta)
    denom = torch.sqrt(tree_dot(delta, delta)) * torch.sqrt(tree_dot(prev_delta, prev_delta))
    return torch.where(denom > _EPS, dot / denom.clamp_min(_EPS), torch.zeros_like(dot))


def delta_leaf_norms(delta: Any) -> Dict[str, torch.Tensor]:
    """‖Δθ‖ per LoRA target (the ``a`` and ``b`` factors together), keyed
    ``es/leaf_delta_norm/<target path>``."""
    groups: Dict[str, list] = {}
    for path, leaf in tree_leaves_with_path(delta):
        name = path.rsplit("/", 1)[0] if "/" in path else (path or "theta")
        groups.setdefault(name, []).append((leaf.to(torch.float32) ** 2).sum())
    return {f"es/leaf_delta_norm/{name}": torch.sqrt(sum(sq)) for name, sq in groups.items()}


def antithetic_pair_asymmetry(opt_scores: torch.Tensor, pop_size: int, antithetic: bool) -> Optional[torch.Tensor]:
    """Mean |r(+ε_b) − r(−ε_b)| over finite antithetic pairs (member ``k``
    pairs with ``k + pop//2``), over the finite-member reward std; ``None``
    without pairs."""
    if not antithetic or pop_size < 2:
        return None
    half = pop_size // 2
    r = opt_scores.to(torch.float32)
    pos, neg = r[:half], r[half:2 * half]
    pair_mask = torch.isfinite(pos) & torch.isfinite(neg)
    diff = torch.where(pair_mask, (pos - neg).abs(), torch.zeros_like(pos))
    mean_diff = diff.sum() / pair_mask.sum().clamp_min(1)
    return mean_diff / (masked_reward_stats(r)["es/reward_std"] + 1e-8)


def es_health_metrics(*, opt_scores: torch.Tensor, fitness: torch.Tensor, delta: Any, prev_delta: Any,
                      cap_theta_scale: torch.Tensor, cap_step_scale: torch.Tensor,
                      pop_size: int, antithetic: bool) -> Dict[str, torch.Tensor]:
    """The whole ``es/`` metrics dict of one step."""
    out = masked_reward_stats(opt_scores)
    out["es/fitness_zero"] = (fitness == 0.0).all().to(torch.float32)
    out["es/update_cosine"] = update_cosine(delta, prev_delta)
    out["es/cap_theta_scale"] = torch.as_tensor(cap_theta_scale, dtype=torch.float32)
    out["es/cap_step_scale"] = torch.as_tensor(cap_step_scale, dtype=torch.float32)
    asym = antithetic_pair_asymmetry(opt_scores, pop_size, antithetic)
    if asym is not None:
        out["es/pair_asym"] = asym
    out.update(delta_leaf_norms(delta))
    return out


class DegeneracyWatchdog:
    """Calls ``on_degenerate(consecutive)`` once when ``es/fitness_zero``
    has read 1 for ``threshold`` consecutive observed generations (the ES
    update has been a no-op: constant or all-NaN rewards); re-arms after a
    healthy one. ``threshold <= 0`` disables it."""

    def __init__(self, threshold: int, on_degenerate: Callable[[int], None]):
        self.threshold = int(threshold)
        self.on_degenerate = on_degenerate
        self.consecutive = 0
        self._fired = False

    def update(self, degenerate: bool) -> int:
        """Feed one generation; returns the consecutive count."""
        if self.threshold <= 0:
            return 0
        if degenerate:
            self.consecutive += 1
            if not self._fired and self.consecutive >= self.threshold:
                self._fired = True
                self.on_degenerate(self.consecutive)
        else:
            self.consecutive = 0
            self._fired = False
        return self.consecutive
