"""Cross-run regression detection: ingest, robust baselines, verdicts (port
of ``hyperscalees_t2i_tpu/obs/regress.py``; ``tools/sentry.py`` is its CLI).

1. **Ingest** (:func:`ingest`) turns a source into flat observations
   ``(metric, key, value)``, each read by its schema:

   - a run dir: ``metrics.jsonl`` (the median steady-state step time, the
     epochs logged, reward means per :data:`REWARD_WINDOW` epochs),
     ``programs.jsonl`` (per ``site/label``: FLOPs, bytes, peak bytes,
     compile seconds where a record has them), ``CAPACITY*``, ``DEGRADE*``,
     ``CALIB*``, ``QUALITY*`` and ``FLEET*`` artifacts;
   - a ``*.jsonl`` ledger (``programs.jsonl``, a preflight ledger);
   - a ``*.json`` artifact: capacity, degrade, calibration, window rollup
     (``WINDOW_r*``), quality, fleet or bench (``BENCH_*``), tried in that
     order.

2. **Baseline** (:func:`build_baselines`): per ``(metric, key)`` over the
   prior runs, the median and the MAD (``utils/stats.py``).

3. **Evaluate** (:func:`evaluate`): per metric class a bound on the side
   that regresses, ``center ± max(k·1.4826·MAD, rel_floor·|center|,
   abs_floor)``. ``torch_sensitive`` metrics (the program's FLOPs and bytes,
   counted by ``obs/program_cost.py`` with torch's formulas) skip, by name,
   under a baseline stamped with another ``torch.__version__``;
   ``chip_sensitive`` ones skip under a baseline measured on another card
   (``torch.cuda.get_device_name``).

The JAX module's skip of ``jax_sensitive`` metrics under another jax is the
port's torch-sensitive skip. Its ledger carries no StableHLO sha, so the
reference's "a matching sha gates even under another jax" has no
counterpart here, and the verdict has no ``sha_changes``. A manifest the
JAX package wrote (``gen_jax``, no ``gen_torch``) counts as stamped with
another version.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

from ..utils.jsonl import read_jsonl_rows
from ..utils.stats import MAD_SIGMA, mad, median

VERDICT_FILE = "sentry_verdict.json"
MANIFEST_SCHEMA = 1

# per metric class: the side that regresses and the tolerance floors
# (generous for wall-clock metrics, tight for the counted program shape)
METRIC_POLICY: Dict[str, Dict[str, Any]] = {
    "step_time_s": dict(direction="upper", mad_k=5.0, rel_floor=0.50, abs_floor=0.0, torch_sensitive=False,
                        chip_sensitive=True),
    "compile_s": dict(direction="upper", mad_k=5.0, rel_floor=1.00, abs_floor=1.0, torch_sensitive=False,
                      chip_sensitive=True),
    "bytes_accessed": dict(direction="upper", mad_k=3.0, rel_floor=0.05, abs_floor=0.0, torch_sensitive=True),
    "flops": dict(direction="upper", mad_k=3.0, rel_floor=0.02, abs_floor=0.0, torch_sensitive=True),
    "peak_bytes": dict(direction="upper", mad_k=3.0, rel_floor=0.10, abs_floor=0.0, torch_sensitive=True),
    "reward_window": dict(direction="lower", mad_k=4.0, rel_floor=0.25, abs_floor=0.05, torch_sensitive=False),
    "epochs_logged": dict(direction="lower", mad_k=0.0, rel_floor=0.0, abs_floor=0.5, torch_sensitive=False),
    # capacity curves: capacity and goodput regress down, the knee's tail up
    "capacity_rps": dict(direction="lower", mad_k=4.0, rel_floor=0.30, abs_floor=0.0, torch_sensitive=False),
    "goodput_rps": dict(direction="lower", mad_k=4.0, rel_floor=0.30, abs_floor=0.0, torch_sensitive=False),
    "knee_p99_s": dict(direction="upper", mad_k=5.0, rel_floor=0.50, abs_floor=0.25, torch_sensitive=False),
    # calibration: measured step time up, measured/predicted up only
    "calib_measured_s": dict(direction="upper", mad_k=5.0, rel_floor=0.50, abs_floor=0.0, torch_sensitive=False,
                             chip_sensitive=True),
    "calib_error_ratio": dict(direction="upper", mad_k=4.0, rel_floor=0.25, abs_floor=0.0, torch_sensitive=False,
                              chip_sensitive=True),
    # quality: higher is better for the reward and its AUC; more images to
    # the threshold is the regression
    "quality_final_reward": dict(direction="lower", mad_k=4.0, rel_floor=0.25, abs_floor=0.0,
                                 torch_sensitive=False),
    "quality_auc_images": dict(direction="lower", mad_k=4.0, rel_floor=0.25, abs_floor=0.0, torch_sensitive=False),
    "quality_images_to_threshold": dict(direction="upper", mad_k=4.0, rel_floor=0.50, abs_floor=8.0,
                                        torch_sensitive=False),
    "goodput_retention": dict(direction="lower", mad_k=4.0, rel_floor=0.15, abs_floor=0.0, torch_sensitive=False),
    "fleet_imgs_per_sec_chip": dict(direction="lower", mad_k=4.0, rel_floor=0.30, abs_floor=0.0,
                                    torch_sensitive=False, chip_sensitive=True),
    "fleet_bytes_per_job": dict(direction="upper", mad_k=3.0, rel_floor=0.05, abs_floor=0.0, torch_sensitive=True),
}

REWARD_WINDOW = 5  # epochs per reward-trajectory comparison window


@dataclasses.dataclass(frozen=True)
class Observation:
    """One normalized measurement from a source."""

    metric: str
    key: str
    value: float
    source: str = ""
    chip: Optional[str] = None  # the device the measurement ran on


@dataclasses.dataclass
class Baseline:
    """Median and MAD of one ``(metric, key)`` over prior runs."""

    metric: str
    key: str
    center: float
    mad: float
    n: int
    chip: Optional[str] = None  # set when every baseline run agreed


def running_torch_version() -> str:
    """The version stamp of the torch-sensitive skip."""
    import torch

    return str(torch.__version__)


def _load_json(path: Path) -> Any:
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None


def _doc_of_mode(path: Path, mode: str) -> Optional[Dict[str, Any]]:
    """The document of ``path`` when its ``mode`` (or a ``parsed``
    wrapper's) is ``mode``."""
    doc = _load_json(path)
    if not isinstance(doc, dict):
        return None
    if doc.get("mode") != mode:
        doc = doc.get("parsed") or {}
        if not isinstance(doc, dict) or doc.get("mode") != mode:
            return None
    return doc


def _positive(v: Any) -> bool:
    return isinstance(v, (int, float)) and v > 0


# ---------------------------------------------------------------------------
# ingestion
# ---------------------------------------------------------------------------

def ingest_ledger(path: Union[str, Path]) -> List[Observation]:
    """Per-program observations of a ``programs.jsonl``-shaped ledger, keyed
    ``site/label``; the last record of a key wins."""
    path = Path(path)
    last: Dict[tuple, Observation] = {}
    for r in read_jsonl_rows(path):
        label = r.get("label")
        if not label:
            continue
        key = f"{r.get('site', '?')}/{label}"
        for metric in ("bytes_accessed", "flops", "peak_bytes", "compile_s"):
            v = r.get(metric)
            if _positive(v):
                last[(metric, key)] = Observation(metric, key, float(v), source=path.name,
                                                  chip=r.get("device_kind") or None)
    return list(last.values())


def ingest_metrics(path: Union[str, Path]) -> List[Observation]:
    """Run-level observations of a ``metrics.jsonl``: the median step time
    of the epochs that compiled nothing (rows where the cumulative
    ``obs/compiles`` counter moved, a reset included, are left out; all rows
    when that leaves none), the number of distinct epochs, and the reward
    mean of each :data:`REWARD_WINDOW`. A resumed run appends to the same
    file: rows fold by epoch, the last occurrence winning."""
    path = Path(path)
    prev_compiles: Optional[float] = None
    by_epoch: Dict[int, Dict[str, Any]] = {}
    for r in read_jsonl_rows(path):
        if "epoch" not in r:
            continue
        comp = r.get("obs/compiles")
        compiled_here = False
        if isinstance(comp, (int, float)):
            compiled_here = float(comp) != (0.0 if prev_compiles is None else prev_compiles)
            prev_compiles = float(comp)
        try:
            ep = int(r["epoch"])
        except (TypeError, ValueError):
            continue
        by_epoch[ep] = {**r, "_compiled_here": compiled_here}
    folded = [by_epoch[e] for e in sorted(by_epoch)]
    timed = [r for r in folded if isinstance(r.get("step_time_s"), (int, float))]
    steps = [float(r["step_time_s"]) for r in timed]
    steady = [float(r["step_time_s"]) for r in timed if not r["_compiled_here"]]
    out: List[Observation] = []
    if steps:
        out.append(Observation("step_time_s", "run", median(steady or steps), source=path.name))
    if folded:
        out.append(Observation("epochs_logged", "run", float(len(folded)), source=path.name))
    rewards = [float(r["opt_score_mean"]) for r in folded if isinstance(r.get("opt_score_mean"), (int, float))]
    for i in range(0, len(rewards), REWARD_WINDOW):
        w = rewards[i:i + REWARD_WINDOW]
        out.append(Observation("reward_window", f"w{i // REWARD_WINDOW}", sum(w) / len(w), source=path.name))
    return out


def ingest_bench(path: Union[str, Path]) -> List[Observation]:
    """Per-rung observations of a bench artifact (``BENCH_*.json``, raw or
    under ``parsed``)."""
    path = Path(path)
    doc = _load_json(path)
    if not isinstance(doc, dict):
        return []
    rungs = doc.get("rungs") or (doc.get("parsed") or {}).get("rungs") or {}
    out: List[Observation] = []
    for rung, row in rungs.items():
        if not isinstance(row, dict):
            continue
        chip = row.get("device_kind") or doc.get("device_kind") or None
        for metric, field, scale in (("step_time_s", "step_time_s", 1.0), ("compile_s", "compile_s", 1.0),
                                     ("bytes_accessed", "bytes_accessed", 1.0), ("flops", "step_tflops", 1e12),
                                     ("peak_bytes", "peak_bytes_est", 1.0)):
            v = row.get(field)
            if _positive(v):
                out.append(Observation(metric, f"bench/{rung}", float(v) * scale, source=path.name, chip=chip))
    return out


def _calib_rows(calib: Dict[str, Any], src: str) -> List[Observation]:
    chip_default = calib.get("chip_kind") or None
    out: List[Observation] = []
    for row in calib.get("rows") or []:
        if not isinstance(row, dict) or not row.get("key"):
            continue
        for metric, field in (("calib_measured_s", "measured_s"), ("calib_error_ratio", "error_ratio")):
            v = row.get(field)
            if _positive(v):
                out.append(Observation(metric, f"calib/{row['key']}", float(v), source=src,
                                       chip=row.get("chip_kind") or chip_default))
    return out


def ingest_calib(path: Union[str, Path]) -> List[Observation]:
    """Per reconciled program of a ``CALIB_*.json``: the measured step time
    and measured/predicted, keyed ``calib/<site>/<label>``."""
    path = Path(path)
    doc = _doc_of_mode(path, "calib")
    return _calib_rows(doc, path.name) if doc else []


def ingest_window(path: Union[str, Path]) -> List[Observation]:
    """The calibration rows embedded in a window rollup (``WINDOW_r*.json``)."""
    path = Path(path)
    doc = _doc_of_mode(path, "window")
    calib = doc.get("calib") if doc else None
    if not isinstance(calib, dict) or calib.get("mode") != "calib":
        return []
    return _calib_rows(calib, path.name)


def ingest_quality(path: Union[str, Path]) -> List[Observation]:
    """The final reward, AUC over images (finite values, negatives allowed)
    and images to threshold (positive) of a ``QUALITY_*.json``, keyed
    ``quality/run``."""
    path = Path(path)
    doc = _doc_of_mode(path, "quality")
    if doc is None:
        return []
    chip = doc.get("chip_kind") or None
    out: List[Observation] = []
    for metric, field in (("quality_final_reward", "final_reward"), ("quality_auc_images", "auc_over_images")):
        v = doc.get(field)
        if isinstance(v, (int, float)) and math.isfinite(v):
            out.append(Observation(metric, "quality/run", float(v), source=path.name, chip=chip))
    v = doc.get("images_to_threshold")
    if _positive(v):
        out.append(Observation("quality_images_to_threshold", "quality/run", float(v), source=path.name, chip=chip))
    return out


def ingest_capacity(path: Union[str, Path]) -> List[Observation]:
    """Capacity, goodput and the knee's p99 of a ``CAPACITY_*.json``, keyed
    ``capacity/<rung>``."""
    path = Path(path)
    doc = _doc_of_mode(path, "capacity")
    if doc is None:
        return []
    key = f"capacity/{doc.get('rung', '?')}"
    return [Observation(m, key, float(doc[m]), source=path.name)
            for m in ("capacity_rps", "goodput_rps", "knee_p99_s") if _positive(doc.get(m))]


def ingest_degrade(path: Union[str, Path]) -> List[Observation]:
    """``goodput_retention`` of a ``DEGRADE_*.json``, keyed ``degrade/<rung>``."""
    path = Path(path)
    doc = _load_json(path)
    if not isinstance(doc, dict) or doc.get("mode") != "degrade":
        return []
    v = doc.get("goodput_retention")
    return ([Observation("goodput_retention", f"degrade/{doc.get('rung', '?')}", float(v), source=path.name)]
            if _positive(v) else [])


def ingest_fleet(path: Union[str, Path]) -> List[Observation]:
    """Per fleet width of a ``FLEET_*.json``: images/s a card and program
    bytes a job, keyed ``fleet/<rung>/j<J>``."""
    path = Path(path)
    doc = _doc_of_mode(path, "fleet")
    if doc is None:
        return []
    chip = doc.get("device_kind") or None
    out: List[Observation] = []
    for row in doc.get("widths") or []:
        if not isinstance(row, dict) or not row.get("width"):
            continue
        key = f"fleet/{doc.get('rung', '?')}/j{row['width']}"
        for metric, field in (("fleet_imgs_per_sec_chip", "fused_imgs_per_sec_chip"),
                              ("fleet_bytes_per_job", "bytes_per_job")):
            if _positive(row.get(field)):
                out.append(Observation(metric, key, float(row[field]), source=path.name, chip=chip))
    return out


def ingest_run_dir(path: Union[str, Path]) -> List[Observation]:
    """A run dir's observations; the wall-clock ones, which ``metrics.jsonl``
    does not stamp, take the ledger's most frequent device."""
    path = Path(path)
    out: List[Observation] = []
    if (path / "metrics.jsonl").exists():
        out.extend(ingest_metrics(path / "metrics.jsonl"))
    ledger_obs: List[Observation] = []
    if (path / "programs.jsonl").exists():
        ledger_obs = ingest_ledger(path / "programs.jsonl")
        out.extend(ledger_obs)
    for pattern, fn in (("CAPACITY*.json", ingest_capacity), ("DEGRADE*.json", ingest_degrade),
                        ("CALIB*.json", ingest_calib), ("QUALITY*.json", ingest_quality),
                        ("FLEET*.json", ingest_fleet)):
        for p in sorted(path.glob(pattern)):
            out.extend(fn(p))
    chips = [o.chip for o in ledger_obs if o.chip]
    if chips:
        dominant = max(set(chips), key=chips.count)
        out = [dataclasses.replace(o, chip=dominant) if o.chip is None else o for o in out]
    return out


def ingest(path: Union[str, Path]) -> List[Observation]:
    """Dispatch on the source's shape; ``ValueError`` for anything else, so
    a wrong path is refused rather than checking nothing."""
    p = Path(path)
    if p.is_dir():
        return ingest_run_dir(p)
    if p.suffix == ".jsonl":
        return ingest_ledger(p)
    if p.suffix == ".json":
        return (ingest_capacity(p) or ingest_degrade(p) or ingest_calib(p) or ingest_window(p)
                or ingest_quality(p) or ingest_fleet(p) or ingest_bench(p))
    raise ValueError(f"unsupported sentry source {p} (want a run dir, a *.jsonl ledger, or a BENCH_*.json / "
                     "CAPACITY_*.json / DEGRADE_*.json / CALIB_*.json / WINDOW_r*.json / QUALITY_*.json / "
                     "FLEET_*.json artifact)")


# ---------------------------------------------------------------------------
# baselines and evaluation
# ---------------------------------------------------------------------------

def build_baselines(runs: Sequence[Sequence[Observation]]) -> List[Baseline]:
    """Median and MAD per ``(metric, key)`` over the prior runs; the device
    is kept only when every run agreed on it (a mixed baseline gates
    ``chip_sensitive`` metrics on any card)."""
    groups: Dict[tuple, List[Observation]] = {}
    for obs_list in runs:
        for o in obs_list:
            groups.setdefault((o.metric, o.key), []).append(o)
    out = []
    for (metric, key), obs in sorted(groups.items()):
        vals = [o.value for o in obs]
        chips = {o.chip for o in obs}
        out.append(Baseline(metric=metric, key=key, center=median(vals), mad=mad(vals), n=len(vals),
                            chip=chips.pop() if len(chips) == 1 else None))
    return out


def tolerance(b: Baseline, policy: Dict[str, Any]) -> float:
    return max(float(policy.get("mad_k", 3.0)) * MAD_SIGMA * b.mad,
               float(policy.get("rel_floor", 0.0)) * abs(b.center), float(policy.get("abs_floor", 0.0)))


def evaluate(baselines: Sequence[Baseline], observations: Sequence[Observation], *,
             torch_version: Optional[str] = None, baseline_torch: Optional[str] = None,
             policy: Optional[Dict[str, Dict[str, Any]]] = None) -> Dict[str, Any]:
    """The verdict of a candidate's observations against the baselines.
    Each baseline is skipped by name when it has no policy, when the
    candidate lacks it, when it is torch-sensitive and the versions differ,
    or when it is chip-sensitive and the devices differ; otherwise a value
    past its bound is a breach naming baseline, observed value and bound.
    ``pass`` means no breach."""
    pol = dict(METRIC_POLICY)
    for k, v in (policy or {}).items():
        pol[k] = {**pol.get(k, {}), **v}
    by_key = {(o.metric, o.key): o for o in observations}
    breaches: List[Dict[str, Any]] = []
    skipped: List[Dict[str, str]] = []
    checked = 0
    torch_mismatch = baseline_torch is not None and torch_version is not None and baseline_torch != torch_version
    for b in baselines:
        p = pol.get(b.metric)
        o = by_key.get((b.metric, b.key))
        reason = None
        if p is None:
            reason = "no policy for metric"
        elif o is None:
            reason = "not observed in candidate"
        elif p.get("torch_sensitive") and torch_mismatch:
            reason = f"torch-sensitive metric: baseline torch {baseline_torch} != running torch {torch_version}"
        elif p.get("chip_sensitive") and b.chip and o.chip != b.chip:
            reason = f"chip-kind mismatch: baseline chip {b.chip} != candidate chip {o.chip or 'unknown'}"
        if reason is not None:
            skipped.append({"metric": b.metric, "key": b.key, "reason": reason})
            continue
        checked += 1
        tol = tolerance(b, p)
        upper = p["direction"] == "upper"
        bound = b.center + tol if upper else b.center - tol
        if (o.value > bound) if upper else (o.value < bound):
            breaches.append({"metric": b.metric, "key": b.key, "baseline": b.center, "baseline_mad": b.mad,
                             "baseline_n": b.n, "observed": o.value, "bound": bound, "direction": p["direction"],
                             "source": o.source})
    return {"schema": MANIFEST_SCHEMA, "pass": not breaches, "checked": checked, "breaches": breaches,
            "skipped": skipped, "torch_version": torch_version, "baseline_torch": baseline_torch}


# ---------------------------------------------------------------------------
# the manifest (a baseline written to a file) and the verdict file
# ---------------------------------------------------------------------------

def manifest_payload(baselines: Sequence[Baseline], note: str = "") -> Dict[str, Any]:
    return {"schema": MANIFEST_SCHEMA, "gen_torch": running_torch_version(), "note": note,
            "entries": [dataclasses.asdict(b) for b in baselines]}


def write_manifest(path: Union[str, Path], baselines: Sequence[Baseline], note: str = "") -> Path:
    path = Path(path)
    path.write_text(json.dumps(manifest_payload(baselines, note), indent=2) + "\n")
    return path


def load_manifest(path: Union[str, Path]) -> Dict[str, Any]:
    """``{"baselines", "gen_torch", "note"}`` of a manifest; ``ValueError``
    on another schema. A manifest the JAX package wrote has ``gen_jax`` and
    no ``gen_torch``: its stamp becomes ``"jax <version>"``, which no torch
    version equals."""
    doc = json.loads(Path(path).read_text())
    if doc.get("schema") != MANIFEST_SCHEMA:
        raise ValueError(f"sentry manifest {path}: schema {doc.get('schema')!r} != {MANIFEST_SCHEMA}")
    gen = doc.get("gen_torch")
    if gen is None and doc.get("gen_jax") is not None:
        gen = f"jax {doc['gen_jax']}"
    baselines = [Baseline(**{k: e.get(k) for k in ("metric", "key", "center", "mad", "n", "chip")})
                 for e in doc.get("entries", [])]
    return {"baselines": baselines, "gen_torch": gen, "note": doc.get("note", "")}


def write_verdict(verdict: Dict[str, Any], out: Union[str, Path]) -> Path:
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".tmp")
    tmp.write_text(json.dumps({**verdict, "ts": time.time()}, indent=2, default=str) + "\n")
    os.replace(tmp, out)
    return out


__all__ = ["Baseline", "METRIC_POLICY", "MANIFEST_SCHEMA", "Observation", "REWARD_WINDOW", "VERDICT_FILE",
           "build_baselines", "evaluate", "ingest", "ingest_bench", "ingest_calib", "ingest_degrade", "ingest_fleet",
           "ingest_ledger", "ingest_metrics", "ingest_quality", "ingest_run_dir", "ingest_window", "load_manifest",
           "manifest_payload", "running_torch_version", "tolerance", "write_manifest", "write_verdict"]
