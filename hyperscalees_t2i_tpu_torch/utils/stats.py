"""Nearest-rank percentiles and robust statistics (a copy of
``hyperscalees_t2i_tpu/utils/stats.py``; standard library only).

- :func:`nearest_rank` / :func:`percentiles`: exact percentiles of a sample
  list, the ``ceil(q·n)``-th order statistic, never interpolated;
- :func:`histogram_quantile` / :func:`histogram_percentiles`: percentiles
  recovered from cumulative bucket counts (Prometheus ``le`` semantics),
  the upper edge of the bucket that holds the nearest-rank sample, so
  within one bucket of the exact value;
- :func:`median` / :func:`mad` / :func:`robust_z`: outlier-resistant
  center, scale and score (MAD scaled by 1.4826, the σ of a normal sample);
- :func:`changepoint_split`: the best two-segment split of a short series;
- :func:`window_anchor_index`: the index of the newest timestamp at or
  before a window's start (the SLO evaluator's window anchor).
"""

from __future__ import annotations

import math
import statistics
from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

PERCENTILE_QS = (0.5, 0.95, 0.99)

# MAD → σ-equivalent scale for a normal sample (1 / Φ⁻¹(3/4))
MAD_SIGMA = 1.4826


def nearest_rank(xs: Sequence[float], q: float) -> float:
    """Nearest-rank ``q``-quantile (0 < q <= 1) of a non-empty sample list.
    The ``ceil(q*n)``-th smallest value — no interpolation, so the result is
    always an observed sample."""
    if not xs:
        raise ValueError("nearest_rank of an empty sample")
    s = sorted(xs)
    idx = max(0, min(len(s) - 1, math.ceil(q * len(s)) - 1))
    return s[idx]


def percentiles(
    xs: Sequence[float], qs: Sequence[float] = PERCENTILE_QS
) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` via :func:`nearest_rank`."""
    return {f"p{round(q * 100):d}": nearest_rank(xs, q) for q in qs}


def histogram_quantile(
    le: Sequence[float], cumulative: Sequence[float], q: float
) -> float:
    """Quantile recovered from cumulative bucket counts (Prometheus ``le``
    semantics: ``cumulative[i]`` = samples <= ``le[i]``; one trailing
    +Inf bucket when ``len(cumulative) == len(le) + 1``).

    Returns the upper edge of the bucket holding the nearest-rank sample —
    within one bucket width of the exact sample percentile. The +Inf bucket
    degrades to the largest finite edge (the honest answer is "beyond the
    layout"; callers wanting to detect that compare against ``le[-1]``).
    """
    if not le:
        raise ValueError("histogram_quantile needs at least one bucket edge")
    total = cumulative[-1] if cumulative else 0
    if total <= 0:
        raise ValueError("histogram_quantile of an empty histogram")
    rank = math.ceil(q * total)
    for i, c in enumerate(cumulative):
        if c >= rank:
            return float(le[i]) if i < len(le) else float(le[-1])
    return float(le[-1])


def histogram_percentiles(
    le: Sequence[float],
    cumulative: Sequence[float],
    qs: Sequence[float] = PERCENTILE_QS,
) -> Dict[str, float]:
    return {
        f"p{round(q * 100):d}": histogram_quantile(le, cumulative, q)
        for q in qs
    }


def median(xs: Sequence[float]) -> float:
    """Exact median of a non-empty sample — a thin wrapper over
    ``statistics.median`` (even-n AVERAGE of the two middles) that raises
    the module's usual ``ValueError`` on empty input and always returns a
    float. Deliberately different from :func:`nearest_rank` at q=0.5,
    which always returns an observed sample (the lower middle for even n)
    — baselines want the unbiased center, report percentile tables want
    values that actually occurred."""
    if not xs:
        raise ValueError("median of an empty sample")
    return float(statistics.median(float(x) for x in xs))


def mad(xs: Sequence[float], center: Optional[float] = None) -> float:
    """Raw median absolute deviation around ``center`` (default: the sample
    median). Multiply by :data:`MAD_SIGMA` for a normal-σ-equivalent scale."""
    c = median(xs) if center is None else float(center)
    return median([abs(float(x) - c) for x in xs])


def robust_z(x: float, xs: Sequence[float], min_scale: float = 0.0) -> float:
    """Robust z-score of ``x`` against the sample ``xs``:
    ``(x − median) / max(1.4826·MAD, min_scale)``.

    A degenerate sample (MAD 0 — e.g. a constant stream) with no
    ``min_scale`` floor returns 0.0 when ``x`` equals the median and ±inf
    otherwise: a constant stream jumping to a new value IS infinitely
    surprising, and callers that want bounded scores pass a floor (the
    anomaly watchdog floors at a fraction of the median's magnitude)."""
    if not xs:
        return 0.0
    c = median(xs)
    scale = max(MAD_SIGMA * mad(xs, c), float(min_scale))
    d = float(x) - c
    if scale <= 0.0:
        return 0.0 if d == 0.0 else math.copysign(math.inf, d)
    return d / scale


def changepoint_split(
    xs: Sequence[float], min_segment: int = 3
) -> Tuple[Optional[int], float]:
    """Best two-segment split of ``xs`` by robust between-segment shift.

    Returns ``(index, score)`` where ``index`` is the start of the second
    segment maximizing ``|median(left) − median(right)|`` normalized by the
    mean within-segment L1 deviation (around each segment's median, floored
    at a small fraction of the shift so two flat segments score finite
    rather than ±inf) — the L1 changepoint criterion: a split that leaves an
    outlier inside a segment pays for it in the denominator, so the exact
    level-shift index wins over near-misses. ``score`` is that normalized
    shift; ``(None, 0.0)`` when the series is too short for two
    ``min_segment``-length segments. O(n²·log n) on the short rolling
    windows it is meant for — not a general CUSUM."""
    n = len(xs)
    m = max(int(min_segment), 1)
    if n < 2 * m:
        return None, 0.0
    best_idx: Optional[int] = None
    best_score = 0.0
    vals = [float(x) for x in xs]
    for k in range(m, n - m + 1):
        left, right = vals[:k], vals[k:]
        ml, mr = median(left), median(right)
        shift = abs(ml - mr)
        if shift == 0.0:
            continue
        cost = (sum(abs(v - ml) for v in left)
                + sum(abs(v - mr) for v in right)) / n
        score = shift / max(cost, 1e-3 * shift, 1e-12)
        if score > best_score:
            best_idx, best_score = k, score
    return best_idx, best_score


def window_anchor_index(ts: Sequence[float], window_start: float) -> int:
    """Index of the newest timestamp at-or-before ``window_start`` (the
    window *anchor*), or 0 when every sample is newer — a short history
    anchors at its oldest sample rather than inventing a denominator. The
    bisect ``obs/slo.py`` used to open-code for both burn windows and the
    prune cut."""
    return max(bisect_right(ts, window_start) - 1, 0)


__all__: List[str] = [
    "MAD_SIGMA",
    "PERCENTILE_QS",
    "changepoint_split",
    "histogram_percentiles",
    "histogram_quantile",
    "mad",
    "median",
    "nearest_rank",
    "percentiles",
    "robust_z",
    "window_anchor_index",
]
