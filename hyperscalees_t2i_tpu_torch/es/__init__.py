"""ES member-axis helpers (serving part so far)."""

from .noiser import lane_slice, stacked_adapter_theta

__all__ = ["lane_slice", "stacked_adapter_theta"]
