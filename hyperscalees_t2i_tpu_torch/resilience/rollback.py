"""The non-finite / divergence guard's policy (port of
``hyperscalees_t2i_tpu/resilience/rollback.py``).

The trainer already fetches ``theta_norm`` every epoch, and one NaN or Inf
anywhere in θ makes the global norm non-finite, so the check costs nothing.
After rolling θ back to the last good slot the policy is one of:

- ``sigma_shrink``: replay from the slot's epoch with σ × ``sigma_shrink``
  (the same epochs' draws with gentler perturbations);
- ``skip``: keep the restored θ and go on past the bad epoch (fresh draws);
- ``halt``: stop. The other two also halt once ``max_rollbacks`` recoveries
  are spent.

The desync check's rollback (``train.trainer``) replays from the last
agreed slot with σ unchanged (``replay``) and draws on the same budget.

Host-side floats only; the trainer does the restore.
"""

from __future__ import annotations

import dataclasses
import math

POLICIES = ("sigma_shrink", "skip", "halt")


@dataclasses.dataclass
class RollbackController:
    policy: str = "sigma_shrink"
    max_rollbacks: int = 3
    sigma_shrink: float = 0.5
    explode_norm: float = 0.0  # 0: only a non-finite θ trips the guard
    rollbacks: int = 0

    def __post_init__(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(f"rollback_policy must be one of {POLICIES}, got {self.policy!r}")

    def is_bad(self, theta_norm) -> bool:
        """True for a non-finite ``theta_norm``, or one above
        ``explode_norm`` when that is set."""
        try:
            v = float(theta_norm)
        except (TypeError, ValueError):
            return False
        if not math.isfinite(v):
            return True
        return self.explode_norm > 0 and v > self.explode_norm

    def next_action(self, action: "str | None" = None) -> str:
        """Count one trip and return what to do now: the policy (or
        ``action``: the desync check's ``replay``, σ untouched), or
        ``halt`` once ``max_rollbacks`` are spent. Every trip draws on the
        same budget."""
        self.rollbacks += 1
        a = self.policy if action is None else action
        if a == "halt" or self.rollbacks > self.max_rollbacks:
            return "halt"
        return a
