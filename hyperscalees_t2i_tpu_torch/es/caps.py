"""Divergence stabilizers over adapter trees (port of
``hyperscalees_t2i_tpu/es/caps.py``): the global θ-norm cap and the
per-step Δθ-norm cap. A limit of ``None`` or ≤ 0 disables a cap. Each cap
returns ``(tree, scale)``: the rescale it applied, 1.0 when it did not
engage."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..utils.pytree import tree_leaves, tree_map, tree_replace_leaves


def global_norm(tree: Any) -> torch.Tensor:
    """L2 norm over every leaf, in f32."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum((leaf.to(torch.float32) ** 2).sum() for leaf in leaves))


def cap_theta_norm(theta: Any, theta_max_norm: Optional[float]) -> Tuple[Any, torch.Tensor]:
    """Rescale θ so its global norm is at most ``theta_max_norm``."""
    if theta_max_norm is None or theta_max_norm <= 0:
        return theta, torch.ones(())
    n = global_norm(theta)
    scale = torch.where(n > theta_max_norm, theta_max_norm / (n + 1e-8), torch.ones_like(n))
    return tree_map(lambda t: t * scale.to(t.dtype), theta), scale.to(torch.float32)


def cap_step_norm(theta_before: Any, theta_after: Any, max_step_norm: Optional[float]) -> Tuple[Any, torch.Tensor]:
    """Clip the update so ‖θ_after − θ_before‖ ≤ ``max_step_norm``."""
    if max_step_norm is None or max_step_norm <= 0:
        return theta_after, torch.ones(())
    before = tree_leaves(theta_before)
    delta = [a - b for a, b in zip(tree_leaves(theta_after), before)]
    dn = global_norm(delta)
    scale = torch.where(dn > max_step_norm, max_step_norm / (dn + 1e-8), torch.ones_like(dn))
    leaves = [b + d * scale.to(d.dtype) for b, d in zip(before, delta)]
    return tree_replace_leaves(theta_before, leaves), scale.to(torch.float32)
