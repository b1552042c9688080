"""Model-FLOPs utilization and the card's peaks (port of
``hyperscalees_t2i_tpu/utils/mfu.py``).

A step's FLOPs come from the program ledger (``obs/program_cost.py``,
counted over the plan's eager warm-up epoch); the peaks are NVIDIA's
published dense figures per card, keyed by ``torch.cuda.get_device_name()``:
bf16 tensor-core FLOP/s, HBM bandwidth (the roofline's second axis) and HBM
capacity. Unknown cards and the CPU give ``None``, so every consumer says
"cannot say" instead of inventing a peak. The port runs one process, so it
has no interconnect table (ROADMAP queue A item 7).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..device import DeviceLike

# (lower-case substring of the device name, value); the first match wins
_PEAK_BF16 = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),  # H100 SXM ("NVIDIA H100 80GB HBM3")
)
_PEAK_HBM_BW = (
    ("h100 pcie", 2.0e12),
    ("h100", 3.35e12),
)
_HBM_BYTES = (
    ("h100 pcie", 80e9),
    ("h100", 80e9),
)


def _kind_lookup(table: Tuple[Tuple[str, float], ...], kind: str) -> Optional[float]:
    kind = (kind or "").lower()
    for tag, value in table:
        if tag in kind:
            return value
    return None


def peak_flops_for_kind(kind: str) -> Optional[float]:
    """Dense bf16 peak FLOP/s of a card by its device name."""
    return _kind_lookup(_PEAK_BF16, kind)


def hbm_bw_for_kind(kind: str) -> Optional[float]:
    """HBM bandwidth (bytes/s) of a card by its device name."""
    return _kind_lookup(_PEAK_HBM_BW, kind)


def hbm_bytes_for_kind(kind: str) -> Optional[float]:
    """HBM capacity (bytes) of a card by its device name."""
    return _kind_lookup(_HBM_BYTES, kind)


def device_kind(device: DeviceLike = None) -> str:
    """The device's name: ``torch.cuda.get_device_name`` for a CUDA device
    (``None``: the current card), ``"cpu"`` for the CPU or when no card is
    present."""
    import torch

    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") or not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(dev)


def device_peak_flops(device: DeviceLike = None) -> Optional[float]:
    """bf16 peak of the device, or None (the CPU, an unknown card)."""
    return peak_flops_for_kind(device_kind(device))


def device_hbm_bandwidth(device: DeviceLike = None) -> Optional[float]:
    """HBM bandwidth of the device, or None (the CPU, an unknown card)."""
    return hbm_bw_for_kind(device_kind(device))


def mfu(step_flops: Optional[float], step_time_s: float, n_devices: int = 1,
        device: DeviceLike = None) -> Optional[float]:
    """``step_flops / (step_time_s · peak · n_devices)``, or None when the
    FLOPs or the peak are unknown."""
    peak = device_peak_flops(device)
    if step_flops is None or peak is None or step_time_s <= 0:
        return None
    return step_flops / (step_time_s * peak * max(n_devices, 1))
