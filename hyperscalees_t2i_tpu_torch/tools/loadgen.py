"""Open-loop load harness and capacity sweep for the serving tier (port of
``hyperscalees_t2i_tpu/tools/loadgen.py``).

Usage, on the card::

    # one window: 8 req/s of Zipf-1.1 Poisson traffic against the tiny rung
    python -m hyperscalees_t2i_tpu_torch.tools.loadgen --rung tiny --rate 8

    # the capacity curve: step the CAPACITY_PLAN rate ladder, detect the knee
    python -m hyperscalees_t2i_tpu_torch.tools.loadgen --sweep --rung flagship \\
        --adapter_batch 4 --rates 4,8,12,16 --window_s 4 --out build/CAPACITY.json

    # overload ON against OFF past the knee
    python -m hyperscalees_t2i_tpu_torch.tools.loadgen --degrade --rung tiny

``--device cpu`` runs the plain path on the CPU.

Open loop: the arrival schedule is computed up front from a seeded Poisson
(or bursty 2-state MMPP) process (:func:`build_schedule`, numpy's seeded
generator: the same config gives the JAX package's schedule) and submitted
on the wall clock whatever the engine completes; each request's
``t_submit`` is backdated to its scheduled arrival, so queue wait and
latency run from the arrival. At window end the backlog is abandoned and
its censored waits (and those of rejected or shed requests) join the
open-loop tail.

Adapters are Zipf(s) over a synthetic population materialized lazily
through the real :class:`~..serve.AdapterStore`
(:class:`SyntheticAdapterPopulation`): a sampled adapter that is not
resident is drawn and admitted with ``put_adapter``, so LRU eviction and
reload churn come from the traffic itself.

The sweep reports per step p50/p95/p99 of completed requests, the
open-loop p99, goodput (completions within the SLO per second), queue and
store figures, and the knee (:func:`detect_knee`). The artifact is stamped
with torch's version, the git sha and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

CAPACITY_SCHEMA_VERSION = 1
DEGRADE_SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# deterministic traffic schedule (no engine: unit-testable alone)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: virtual arrival time (seconds from window
    start), Zipf-sampled adapter index, prompt count, and request seed."""

    t: float
    adapter_index: int
    n_prompts: int
    seed: int


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """The seeded workload definition. Everything the schedule depends on
    lives here, so same config → bit-identical schedule (tested)."""

    rate_rps: float
    window_s: float
    seed: int = 0
    process: str = "poisson"  # "poisson" | "mmpp"
    # MMPP (bursty) mode: 2 states with equal expected dwell, rates
    # rate*burst_factor (burst) and rate*(2-burst_factor) (calm), so the
    # time-average stays rate_rps; burst_factor must sit in (1, 2)
    burst_factor: float = 1.8
    burst_dwell_s: float = 1.0
    zipf_s: float = 1.1
    population: int = 1000
    # prompt-count mix: {n_prompts: weight} — requests with different
    # counts are different serve geometries (their own compiled program)
    geometry_mix: Tuple[Tuple[int, float], ...] = ((1, 1.0),)


def zipf_weights(population: int, s: float) -> np.ndarray:
    """Normalized Zipf(s) pmf over ranks 1..population. Explicit inverse-
    CDF sampling over a FINITE population — ``np.random.zipf`` samples the
    unbounded distribution and cannot honor a tenant-count cap."""
    if population < 1:
        raise ValueError(f"population must be >= 1, got {population}")
    w = np.arange(1, population + 1, dtype=np.float64) ** (-float(s))
    return w / w.sum()


def _interarrivals(rng: np.random.Generator, cfg: TrafficConfig) -> List[float]:
    """Arrival times in [0, window) for the configured process."""
    ts: List[float] = []
    if cfg.process == "poisson":
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / cfg.rate_rps))
            if t >= cfg.window_s:
                break
            ts.append(t)
        return ts
    if cfg.process != "mmpp":
        raise ValueError(f"unknown arrival process {cfg.process!r}")
    if not 1.0 < cfg.burst_factor < 2.0:
        raise ValueError(
            f"burst_factor must be in (1, 2) so the calm-state rate "
            f"rate*(2-burst_factor) stays positive, got {cfg.burst_factor}"
        )
    rates = (cfg.rate_rps * cfg.burst_factor,
             cfg.rate_rps * (2.0 - cfg.burst_factor))
    state = 0  # start bursting: the knee under bursty load is the point
    t = 0.0
    while t < cfg.window_s:
        dwell = float(rng.exponential(cfg.burst_dwell_s))
        seg_end = min(t + dwell, cfg.window_s)
        tt = t
        while True:
            tt += float(rng.exponential(1.0 / rates[state]))
            if tt >= seg_end:
                break
            ts.append(tt)
        t = seg_end
        state = 1 - state
    return ts


def build_schedule(cfg: TrafficConfig) -> List[Arrival]:
    """The full deterministic schedule for one window: seeded arrivals,
    Zipf adapter ranks, geometry-mix prompt counts, per-request seeds.
    Independent of any engine — the open-loop contract is structural."""
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(cfg.seed), 0xCA9AC177])
    ))
    ts = _interarrivals(rng, cfg)
    n = len(ts)
    cum = np.cumsum(zipf_weights(cfg.population, cfg.zipf_s))
    adapter_idx = np.searchsorted(cum, rng.random(n), side="right")
    counts = [int(c) for c, _ in cfg.geometry_mix]
    weights = np.asarray([w for _, w in cfg.geometry_mix], np.float64)
    if not len(counts) or np.any(weights < 0) or weights.sum() <= 0:
        raise ValueError(f"bad geometry mix {cfg.geometry_mix!r}")
    n_prompts = rng.choice(counts, size=n, p=weights / weights.sum())
    seeds = rng.integers(0, 2**31 - 1, size=n)
    return [
        Arrival(t=float(ts[i]), adapter_index=int(adapter_idx[i]),
                n_prompts=int(n_prompts[i]), seed=int(seeds[i]))
        for i in range(n)
    ]


# ---------------------------------------------------------------------------
# synthetic adapter population (lazy, through the real store)
# ---------------------------------------------------------------------------

class SyntheticAdapterPopulation:
    """Tenant ``synth-<rank>`` for every Zipf rank, drawn on first touch
    (and again after an eviction) as the template plus ``scale`` times one
    flat normal draw from ``fold_in(PRNGKey(seed), rank)`` (the port's
    threefry stream), cut into the leaves in their flattening order, made
    on ``device`` (default: the template's). One draw, not one a leaf: a
    flagship adapter is 328 leaves and ≈ 6M values, and each draw costs a
    fixed ≈ 170 launches, which would stall the open-loop submit loop at every
    store miss. The same rank always gives the same bytes on a device, so
    the store's content sha behaves as for trained adapters."""

    def __init__(self, template: Any, seed: int = 0, scale: float = 0.05, device: Any = None):
        from ..utils.pytree import tree_leaves

        self.template = template
        self._leaves = tree_leaves(template)
        self.device = torch.device(device) if device is not None else self._leaves[0].device
        self.seed = int(seed)
        self.scale = float(scale)
        # synthesis work the store misses caused
        self.materializations = 0

    @staticmethod
    def adapter_id(index: int) -> str:
        return f"synth-{index:06d}"

    def theta_for(self, index: int) -> Any:
        from ..utils import threefry
        from ..utils.pytree import tree_map

        key = threefry.fold_in(threefry.prng_key(self.seed, self.device), int(index))
        z = threefry.normal(key, (sum(t.numel() for t in self._leaves),))
        offset = [0]

        def perturb(t: torch.Tensor) -> torch.Tensor:
            part = z[offset[0]:offset[0] + t.numel()].reshape(t.shape)
            offset[0] += t.numel()
            return (t.detach().to(self.device, torch.float32) + self.scale * part).to(t.dtype)

        return tree_map(perturb, self.template)

    def ensure(self, engine: Any, index: int) -> str:
        """A resident adapter is a store hit at dispatch; a non-resident one
        is a counted miss followed by a real ``put_adapter``."""
        aid = self.adapter_id(index)
        try:
            engine.store.entry(aid)
        except KeyError:
            self.materializations += 1
            engine.put_adapter(aid, self.theta_for(index))
        return aid


# ---------------------------------------------------------------------------
# one open-loop window
# ---------------------------------------------------------------------------

def run_step(
    engine: Any,
    pop: Any,
    arrivals: Sequence[Arrival],
    window_s: float,
    slo_p99_s: float,
    offered_rps: float,
    deadline_s: Optional[float] = None,
) -> Dict[str, Any]:
    """Drive one window of the schedule against the engine, open-loop:
    due arrivals are always submitted (backdated to their scheduled time)
    before the next single-batch dispatch, and at window end the backlog is
    abandoned — its censored waits join the open-loop tail instead of
    vanishing. Engine/population are duck-typed (submit/flush/queue/
    abandon_queued/store · ensure) so the open-loop invariant is testable
    against a deliberately slow fake engine.

    ``deadline_s`` gives every request a relative deadline from
    its scheduled arrival. The client abandons on expiry: an engine-side
    SHED (typed refusal or shed result — overload layer armed) and a
    completion that lands past its deadline (layer off — the client already
    walked away) both count as ``shed``/``client_expired`` rather than
    completions, and their censored waits STAY in ``p99_open_s`` — deadline
    traffic must not make the tail look better by deleting its victims."""
    from ..serve.admission import ServeShedError
    from ..serve.batcher import QueueFullError
    from ..utils.stats import percentiles

    store_stats0 = engine.store.stats()
    snap_fn = getattr(engine, "overload_snapshot", None)
    over0 = snap_fn() if callable(snap_fn) else None
    num_items = max(int(getattr(engine.backend, "num_items", 1) or 1), 1)
    submit_kwargs: Dict[str, Any] = (
        {"deadline_s": float(deadline_s)} if deadline_s is not None else {}
    )
    t0 = time.perf_counter()
    window_end = t0 + float(window_s)
    i = 0
    completed: List[Any] = []
    rejected_waits: List[float] = []
    shed_waits: List[float] = []
    errors = 0
    shed = 0
    client_expired = 0
    max_depth = 0

    def _consume(results: Sequence[Any]) -> None:
        nonlocal errors, shed, client_expired
        for r in results:
            if r.ok:
                if (deadline_s is not None
                        and float(r.latency_s) > float(deadline_s)):
                    # served, but past the client's deadline — the client
                    # abandoned at expiry, so this is censored tail, not
                    # a completion (and never goodput)
                    client_expired += 1
                    shed_waits.append(float(r.latency_s))
                else:
                    completed.append(r)
            elif getattr(r, "shed_reason", None):
                shed += 1
                shed_waits.append(max(float(r.latency_s), 0.0))
            else:
                errors += 1

    while True:
        now = time.perf_counter()
        while i < len(arrivals) and t0 + arrivals[i].t <= now:
            a = arrivals[i]
            i += 1
            aid = pop.ensure(engine, a.adapter_index)
            prompt_ids = [(a.adapter_index + j) % num_items
                          for j in range(a.n_prompts)]
            try:
                engine.submit(aid, prompt_ids, a.seed, t_submit=t0 + a.t,
                              **submit_kwargs)
            except QueueFullError:
                rejected_waits.append(
                    max(time.perf_counter() - (t0 + a.t), 0.0))
            except ServeShedError:
                shed += 1
                shed_waits.append(
                    max(time.perf_counter() - (t0 + a.t), 0.0))
            except Exception:
                errors += 1
        max_depth = max(max_depth, engine.queue.depth)
        if now >= window_end and i >= len(arrivals):
            break
        if engine.queue.depth:
            _consume(engine.flush(max_batches=1))
        else:
            next_t = t0 + arrivals[i].t if i < len(arrivals) else window_end
            time.sleep(max(0.0, min(next_t, window_end)
                           - time.perf_counter()))
    end_depth = int(engine.queue.depth)
    abandoned = engine.abandon_queued()
    t_end = time.perf_counter()

    lat = [float(r.latency_s) for r in completed]
    # the open-loop tail: completed latencies + censored waits of requests
    # the window never served (still queued or rejected). Each censored
    # sample is a LOWER bound on that request's latency, so the open-loop
    # p99 is itself a lower bound — already past the SLO is past the SLO.
    censored = [max(t_end - float(r.t_submit), 0.0) for r in abandoned]
    censored += rejected_waits
    censored += shed_waits
    open_samples = lat + censored
    pct = percentiles(lat) if lat else {}
    open_p99 = percentiles(open_samples)["p99"] if open_samples else None
    accepted = len(completed) + len(abandoned) + errors + shed + client_expired
    good = sum(1 for v in lat if v <= slo_p99_s)
    store_stats1 = engine.store.stats()
    d_hits = int(store_stats1.get("hits", 0)) - int(store_stats0.get("hits", 0))
    d_miss = int(store_stats1.get("misses", 0)) - int(store_stats0.get("misses", 0))
    adapter_batch = int(getattr(getattr(engine, "cfg", None),
                                "adapter_batch", 1) or 1)
    # unbounded growth: the end-of-window backlog exceeds what one dispatch
    # clears AND a non-trivial share of everything accepted — a last-moment
    # burst leaves a few stragglers, saturation leaves a standing queue
    unbounded = (end_depth > adapter_batch
                 and end_depth > 0.05 * max(accepted, 1))
    occ = [float(r.batch_occupancy) for r in completed]
    over1 = snap_fn() if callable(snap_fn) else None
    overload_row: Dict[str, Any] = {}
    if over1 is not None and over0 is not None:
        shed_by_reason = {
            k: int(over1.get("shed", {}).get(k, 0))
               - int(over0.get("shed", {}).get(k, 0))
            for k in set(over1.get("shed", {})) | set(over0.get("shed", {}))
        }
        overload_row = {
            "overload_enabled": bool(over1.get("enabled")),
            "shed_by_reason": {k: v for k, v in
                               sorted(shed_by_reason.items()) if v},
            "degraded_completed": sum(
                1 for r in completed if getattr(r, "degraded", False)),
            "degraded_total": int(over1.get("degraded_total", 0))
                              - int(over0.get("degraded_total", 0)),
            "not_resident_refusals": int(over1.get("not_resident_refusals", 0))
                                     - int(over0.get("not_resident_refusals", 0)),
            "lease_blocked_evictions": int(over1.get("lease_blocked_evictions", 0))
                                       - int(over0.get("lease_blocked_evictions", 0)),
            "leases_active_end": int(over1.get("leases_active", 0)),
            "breakers_open_end": int(over1.get("breakers_open", 0)),
            "pressure_rung_end": over1.get("rung"),
        }
    return {
        "offered_rps": float(offered_rps),
        "window_s": float(window_s),
        "arrivals": len(arrivals),
        "completed": len(completed),
        "rejected": len(rejected_waits),
        "abandoned": len(abandoned),
        "errors": errors,
        # engine-side sheds (submit refusals + queued/doomed sheds) and
        # client-side deadline expiries — both censored into p99_open_s
        "shed": shed,
        "client_expired": client_expired,
        "deadline_s": float(deadline_s) if deadline_s is not None else None,
        "p50_s": round(pct["p50"], 6) if pct else None,
        "p95_s": round(pct["p95"], 6) if pct else None,
        "p99_s": round(pct["p99"], 6) if pct else None,
        # completed + censored (still-queued / rejected) — the honest tail
        "p99_open_s": round(open_p99, 6) if open_p99 is not None else None,
        "goodput_rps": round(good / float(window_s), 4),
        "slo_ok_share": round(good / len(lat), 4) if lat else None,
        "queue_end_depth": end_depth,
        "queue_max_depth": int(max_depth),
        "queue_unbounded": bool(unbounded),
        "batch_occupancy_mean": round(sum(occ) / len(occ), 4) if occ else None,
        "store_hits": d_hits,
        "store_misses": d_miss,
        "store_hit_rate": round(d_hits / (d_hits + d_miss), 4)
                          if d_hits + d_miss else None,
        "store_evictions": int(store_stats1.get("evictions", 0))
                           - int(store_stats0.get("evictions", 0)),
        "store_resident": store_stats1.get("resident"),
        "store_resident_bytes": store_stats1.get("resident_bytes"),
        **overload_row,
    }


# ---------------------------------------------------------------------------
# knee detection + the sweep
# ---------------------------------------------------------------------------

def detect_knee(
    steps: Sequence[Dict[str, Any]], slo_p99_s: float
) -> Tuple[Optional[Dict[str, Any]], float, float, Optional[float]]:
    """``(knee, capacity_rps, goodput_rps, knee_p99_s)`` over the per-step
    rows (ladder order). The knee is the FIRST step whose open-loop p99
    exceeds the SLO or whose queue growth is unbounded; capacity is the
    highest pre-knee rate that met the SLO (0.0 when even the first rate
    failed — an honest number, not a crash)."""
    knee: Optional[Dict[str, Any]] = None
    capacity = 0.0
    goodput = 0.0
    for s in steps:
        p99 = s.get("p99_open_s")
        over = p99 is not None and p99 > slo_p99_s
        if knee is None and (over or s.get("queue_unbounded")):
            knee = {
                "rate_rps": s["offered_rps"],
                "reason": "p99_slo" if over else "queue_growth",
                "p99_open_s": p99,
            }
        if knee is None and not over:
            capacity = float(s["offered_rps"])
            goodput = float(s.get("goodput_rps") or 0.0)
    knee_p99 = knee["p99_open_s"] if knee else None
    return knee, capacity, goodput, knee_p99


def _stamp(device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Provenance: torch's version, the short git sha, and on the card its
    name and ``nvidia-smi``'s name and power limit (each best-effort)."""
    out: Dict[str, Any] = {"torch_version": torch.__version__, "git_sha": None, "card": None,
                           "device_kind": None}
    try:
        r = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=str(Path(__file__).resolve().parent),
                           capture_output=True, text=True, timeout=10)
        out["git_sha"] = r.stdout.strip() or None
    except Exception:
        pass
    if device is not None and torch.device(device).type == "cuda":
        out["device_kind"] = torch.cuda.get_device_name(torch.device(device))
        try:
            r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=60)
            out["card"] = r.stdout.strip().splitlines()[0] if r.stdout.strip() else None
        except Exception:
            pass
    return out


def build_engine(rung: str, store_adapters: int, *, metrics_port: int = 0, max_queue: int = 1024,
                 overload: Any = None, backend: Any = None, template: Any = None, device: Any = None,
                 adapter_batch: Optional[int] = None, slo: Optional[str] = None) -> Tuple[Any, Any]:
    """``(engine, population)`` for the rung's ``SERVE_PLAN`` geometry
    (``adapter_batch`` overrides its lanes), the store budget given in
    adapters (bytes from the rung's real adapter size, so the Zipf tail
    forces eviction). ``backend``/``template`` reuse a built backend (the
    degrade harness builds its ON and OFF engines over one)."""
    from ..backends.sana_backend import build_serve_backend
    from ..rungs import RUNG_BASE_QUANT, RUNG_PLAN, SERVE_PLAN, sana_rung_model
    from ..serve import ServeConfig, ServeEngine
    from ..serve.adapter_store import adapter_bytes
    from ..utils import threefry

    plan = SERVE_PLAN.get(rung, {})
    if backend is None:
        backend = build_serve_backend(sana_rung_model(RUNG_PLAN[rung][0])["bcfg"], RUNG_BASE_QUANT.get(rung, "off"),
                                      device=device, seed=0)
    if template is None:
        template = backend.init_theta(threefry.prng_key(0, backend.device))
    cfg = ServeConfig(
        adapter_batch=int(adapter_batch or plan.get("adapter_batch", 4)),
        images_per_request=int(plan.get("images_per_request", 1)),
        member_batch=int(plan.get("member_batch", 0)), max_queue=int(max_queue),
        adapter_budget_bytes=int(store_adapters) * int(adapter_bytes(template)),
        metrics_port=int(metrics_port), metrics_host="127.0.0.1", slo=slo, overload=overload,
        device=backend.device,
    )
    engine = ServeEngine(backend, cfg, theta_template=template)
    return engine, SyntheticAdapterPopulation(template, seed=0, device=backend.device)


def _platform(doc: Dict[str, Any], device: torch.device) -> None:
    doc["platform"] = "gpu" if device.type == "cuda" else "cpu"
    doc["n_devices"] = torch.cuda.device_count() if device.type == "cuda" else 1


def run_sweep(
    rung: str,
    rates: Sequence[float],
    *,
    seed: int = 0,
    window_s: float = 4.0,
    process: str = "poisson",
    burst_factor: float = 1.8,
    burst_dwell_s: float = 1.0,
    zipf_s: float = 1.1,
    population: int = 64,
    store_adapters: int = 24,
    slo_p99_s: float = 2.0,
    geometry_mix: Tuple[Tuple[int, float], ...] = ((1, 1.0),),
    metrics_port: int = 0,
    max_queue: int = 1024,
    topk: int = 10,
    engine: Any = None,
    pop: Any = None,
    deadline_s: Optional[float] = None,
    overload: Any = None,
    device: Any = None,
    adapter_batch: Optional[int] = None,
) -> Dict[str, Any]:
    """Step offered load up the rate ladder against one warmed engine and
    return the capacity document. ``engine``/``pop`` reuse a built engine;
    otherwise the rung's geometry is built and warmed here (its capture
    lands before the first timed window)."""
    owns_engine = engine is None
    if owns_engine:
        engine, pop = build_engine(rung, store_adapters, metrics_port=metrics_port, max_queue=max_queue,
                                   overload=overload, device=device, adapter_batch=adapter_batch)
        print(f"[loadgen] {rung}: warming serve geometry (adapter_batch={engine.cfg.adapter_batch})",
              file=sys.stderr, flush=True)
        engine.warmup([(int(b), None) for b, _ in geometry_mix])
    steps: List[Dict[str, Any]] = []
    try:
        for rate in rates:
            tcfg = TrafficConfig(rate_rps=float(rate), window_s=float(window_s), seed=int(seed), process=process,
                                 burst_factor=float(burst_factor), burst_dwell_s=float(burst_dwell_s),
                                 zipf_s=float(zipf_s), population=int(population), geometry_mix=tuple(geometry_mix))
            row = run_step(engine, pop, build_schedule(tcfg), window_s, slo_p99_s, rate, deadline_s=deadline_s)
            steps.append(row)
            print(f"[loadgen] {rung}: rate {rate:g} req/s -> completed {row['completed']}/{row['arrivals']} "
                  f"p99_open {row['p99_open_s']} hit_rate {row['store_hit_rate']} endq {row['queue_end_depth']}",
                  file=sys.stderr, flush=True)
    finally:
        if owns_engine:
            engine.close()
    knee, capacity, goodput, knee_p99 = detect_knee(steps, slo_p99_s)
    store = engine.store.stats()
    doc: Dict[str, Any] = {
        "mode": "capacity",
        "schema_version": CAPACITY_SCHEMA_VERSION,
        "metric": "open-loop serving capacity (req/s at p99 <= SLO)",
        "rung": rung,
        "seed": int(seed),
        "process": process,
        "zipf_s": float(zipf_s),
        "population": int(population),
        "geometry_mix": [[int(b), float(w)] for b, w in geometry_mix],
        "window_s": float(window_s),
        "slo_p99_s": float(slo_p99_s),
        "adapter_batch": int(engine.cfg.adapter_batch),
        "max_queue": int(engine.cfg.max_queue),
        "store_budget_bytes": int(engine.cfg.adapter_budget_bytes),
        "store_budget_adapters": int(store_adapters),
        "rates": [float(r) for r in rates],
        "steps": steps,
        "knee": knee,
        "capacity_rps": float(capacity),
        "goodput_rps": float(goodput),
        "knee_p99_s": knee_p99,
        "headline": (f"{capacity:g} req/s at open-loop p99 <= {slo_p99_s:g}s under Zipf-{zipf_s:g} ({process}, "
                     f"{population} adapters, store budget {store_adapters})"),
        "adapter_hotness": [{"adapter": aid, "requests": n} for aid, n in engine.hot_adapters(topk)],
        "adapters_seen": len(engine.hot_adapters(10 ** 9)),
        "adapters_materialized": getattr(pop, "materializations", None),
        "store": {k: store.get(k) for k in ("resident", "resident_bytes", "budget_bytes", "hits", "misses",
                                            "evictions")},
        **_stamp(engine.device),
    }
    _platform(doc, engine.device)
    return doc


# ---------------------------------------------------------------------------
# degrade harness: past-knee overload ON against OFF
# ---------------------------------------------------------------------------

def run_degrade(
    rung: str,
    rates: Sequence[float],
    *,
    seed: int = 0,
    window_s: float = 4.0,
    process: str = "poisson",
    burst_factor: float = 1.8,
    burst_dwell_s: float = 1.0,
    zipf_s: float = 1.1,
    population: int = 64,
    store_adapters: int = 24,
    slo_p99_s: float = 2.0,
    geometry_mix: Tuple[Tuple[int, float], ...] = ((1, 0.8), (2, 0.2)),
    metrics_port: int = 0,
    max_queue: int = 1024,
    topk: int = 10,
    deadline_s: Optional[float] = None,
    overload_rate_rps: Optional[float] = None,
    backend: Any = None,
    template: Any = None,
    capacity: Optional[Dict[str, Any]] = None,
    device: Any = None,
    adapter_batch: Optional[int] = None,
) -> Dict[str, Any]:
    """The graceful-degradation experiment: the knee with the overload layer
    OFF (a capacity ladder, unless ``capacity`` gives one already measured
    with the same traffic), then one window at ``overload_rate_rps``
    (default 2× the knee) with the layer OFF and one with it ON (the client
    deadline, default the SLO, as its default deadline), each on a fresh
    engine over one backend. ``goodput_retention`` is the ON window's
    goodput over the capacity goodput."""
    from ..backends.sana_backend import build_serve_backend
    from ..rungs import RUNG_BASE_QUANT, RUNG_PLAN, sana_rung_model
    from ..serve import OverloadConfig
    from ..utils import threefry

    deadline = float(deadline_s) if deadline_s is not None else float(slo_p99_s)
    if backend is None:
        backend = build_serve_backend(sana_rung_model(RUNG_PLAN[rung][0])["bcfg"], RUNG_BASE_QUANT.get(rung, "off"),
                                      device=device, seed=0)
    if template is None:
        template = backend.init_theta(threefry.prng_key(0, backend.device))
    warm_geoms = [(int(b), None) for b, _ in geometry_mix]
    common = dict(max_queue=max_queue, backend=backend, template=template, adapter_batch=adapter_batch)

    off_engine, off_pop = build_engine(rung, store_adapters, **common)
    off_engine.warmup(warm_geoms)
    try:
        if capacity is None:
            print(f"[loadgen] {rung}: degrade phase 1 — OFF capacity ladder", file=sys.stderr, flush=True)
            capacity = run_sweep(rung, rates, seed=seed, window_s=window_s, process=process,
                                 burst_factor=burst_factor, burst_dwell_s=burst_dwell_s, zipf_s=zipf_s,
                                 population=population, store_adapters=store_adapters, slo_p99_s=slo_p99_s,
                                 geometry_mix=geometry_mix, max_queue=max_queue, topk=topk, engine=off_engine,
                                 pop=off_pop)
        knee = capacity.get("knee")
        knee_rate = float(knee["rate_rps"]) if knee else float(max(capacity.get("rates") or rates))
        rate = float(overload_rate_rps) if overload_rate_rps else 2.0 * knee_rate
        tcfg = TrafficConfig(rate_rps=rate, window_s=float(window_s), seed=int(seed) + 1, process=process,
                             burst_factor=float(burst_factor), burst_dwell_s=float(burst_dwell_s),
                             zipf_s=float(zipf_s), population=int(population), geometry_mix=tuple(geometry_mix))
        arrivals = build_schedule(tcfg)
        print(f"[loadgen] {rung}: degrade phase 2 — OFF past-knee window ({rate:g} req/s = "
              f"{rate / max(knee_rate, 1e-9):.1f}x knee)", file=sys.stderr, flush=True)
        off_row = run_step(off_engine, off_pop, arrivals, window_s, slo_p99_s, rate)
    finally:
        off_engine.close()

    on_engine, on_pop = build_engine(rung, store_adapters, metrics_port=metrics_port,
                                     overload=OverloadConfig(deadline_default_s=deadline), **common)
    print(f"[loadgen] {rung}: degrade phase 3 — ON past-knee window (deadline {deadline:g}s)", file=sys.stderr,
          flush=True)
    on_engine.warmup(warm_geoms)
    try:
        on_row = run_step(on_engine, on_pop, arrivals, window_s, slo_p99_s, rate, deadline_s=deadline)
        on_snapshot = on_engine.overload_snapshot()
    finally:
        on_engine.close()

    cap_goodput = float(capacity.get("goodput_rps") or 0.0)
    on_goodput = float(on_row.get("goodput_rps") or 0.0)
    off_goodput = float(off_row.get("goodput_rps") or 0.0)
    retention = round(on_goodput / cap_goodput, 4) if cap_goodput else None
    off_retention = round(off_goodput / cap_goodput, 4) if cap_goodput else None
    doc: Dict[str, Any] = {
        "mode": "degrade",
        "schema_version": DEGRADE_SCHEMA_VERSION,
        "metric": "past-knee goodput retention (overload layer ON vs OFF)",
        "rung": rung,
        "seed": int(seed),
        "process": process,
        "zipf_s": float(zipf_s),
        "population": int(population),
        "store_budget_adapters": int(store_adapters),
        "geometry_mix": [[int(b), float(w)] for b, w in geometry_mix],
        "window_s": float(window_s),
        "slo_p99_s": float(slo_p99_s),
        "deadline_s": deadline,
        "max_queue": int(max_queue),
        "capacity": {"rates": capacity.get("rates"), "knee": knee, "capacity_rps": capacity.get("capacity_rps"),
                     "goodput_rps": cap_goodput, "steps": capacity.get("steps")},
        "overload_rate_rps": rate,
        "off": off_row,
        "on": on_row,
        "on_overload": on_snapshot,
        "goodput_retention": retention,
        "off_goodput_retention": off_retention,
        "on_p99_s": on_row.get("p99_s"),
        "on_not_resident_refusals": on_row.get("not_resident_refusals"),
        "off_not_resident_refusals": off_row.get("not_resident_refusals"),
        "headline": (f"ON keeps {retention if retention is not None else '?'}x of capacity goodput at {rate:g} req/s "
                     f"({rate / max(knee_rate, 1e-9):.1f}x knee); OFF keeps "
                     f"{off_retention if off_retention is not None else '?'}x"),
        **_stamp(backend.device),
    }
    _platform(doc, backend.device)
    return doc


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def parse_geometry_mix(spec: str) -> Tuple[Tuple[int, float], ...]:
    """``"1:0.9,2:0.1"`` → ((1, 0.9), (2, 0.1)). Weights need not sum to 1
    (normalized at sampling); counts must be positive ints."""
    out = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        b, _, w = part.partition(":")
        n = int(b)
        if n < 1:
            raise ValueError(f"geometry mix prompt count must be >= 1: {part!r}")
        out.append((n, float(w) if w else 1.0))
    if not out:
        raise ValueError(f"empty geometry mix {spec!r}")
    return tuple(out)


def main(argv=None) -> int:
    from ..device import resolve_device
    from ..rungs import CAPACITY_PLAN

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rung", default="tiny", help="serve geometry rung (SERVE_PLAN/CAPACITY_PLAN)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--adapter_batch", type=int, default=None, help="lanes a dispatch (default: SERVE_PLAN's)")
    ap.add_argument("--sweep", action="store_true", help="step the rate ladder and detect the knee")
    ap.add_argument("--degrade", action="store_true",
                    help="OFF capacity ladder, then past-knee windows OFF and overload ON ('mode: degrade')")
    ap.add_argument("--deadline_s", type=float, default=None,
                    help="per-request deadline from the scheduled arrival (default for --degrade: the SLO)")
    ap.add_argument("--overload", action="store_true",
                    help="arm the overload layer (--deadline_s becomes its default deadline) for --rate/--sweep")
    ap.add_argument("--overload_rate", type=float, default=None,
                    help="--degrade past-knee offered load (default: 2x the measured knee)")
    ap.add_argument("--rate", type=float, default=None, help="single-step offered load, req/s")
    ap.add_argument("--rates", default=None, help="comma rate ladder for --sweep (default: CAPACITY_PLAN[rung])")
    ap.add_argument("--window_s", type=float, default=None, help="seconds of offered traffic per step")
    ap.add_argument("--seed", type=int, default=0, help="schedule seed (same seed -> the same arrivals)")
    ap.add_argument("--process", choices=("poisson", "mmpp"), default="poisson",
                    help="arrival process (mmpp = bursty 2-state)")
    ap.add_argument("--burst_factor", type=float, default=1.8, help="mmpp burst-state rate multiplier, in (1,2)")
    ap.add_argument("--burst_dwell_s", type=float, default=1.0, help="mmpp mean state dwell, seconds")
    ap.add_argument("--zipf_s", type=float, default=None, help="adapter popularity exponent")
    ap.add_argument("--population", type=int, default=None, help="synthetic adapter population size")
    ap.add_argument("--store_adapters", type=int, default=None, help="store residency budget, in adapters")
    ap.add_argument("--slo_p99_s", type=float, default=None, help="open-loop p99 SLO defining capacity")
    ap.add_argument("--geometry_mix", default=None, help="prompt-count mix, e.g. '1:0.9,2:0.1'")
    ap.add_argument("--max_queue", type=int, default=1024, help="engine queue bound")
    ap.add_argument("--metrics_port", type=int, default=0, help="serve /metrics + /healthz during the run")
    ap.add_argument("--topk", type=int, default=10, help="hot-adapter table size in the artifact")
    ap.add_argument("--out", default=None, help="artifact path (JSON)")
    ap.add_argument("--run_dir", default=None, help="run dir: per-request trace.jsonl + a copy of the artifact")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    plan = CAPACITY_PLAN.get(args.rung, CAPACITY_PLAN["tiny"])
    window_s = args.window_s if args.window_s is not None else plan["window_s"]
    zipf_s = args.zipf_s if args.zipf_s is not None else plan["zipf_s"]
    population = args.population if args.population is not None else plan["population"]
    store_adapters = args.store_adapters if args.store_adapters is not None else plan["store_adapters"]
    slo = args.slo_p99_s if args.slo_p99_s is not None else plan["slo_p99_s"]
    mix = (parse_geometry_mix(args.geometry_mix) if args.geometry_mix
           else (((1, 0.8), (2, 0.2)) if args.degrade else ((1, 1.0),)))
    if args.sweep or args.degrade:
        rates = [float(r) for r in args.rates.split(",")] if args.rates else [float(r) for r in plan["rates"]]
    else:
        rates = [args.rate if args.rate is not None else plan["rates"][0]]
    run_dir = Path(args.run_dir) if args.run_dir else None
    tracing = contextlib.nullcontext()
    if run_dir is not None:
        from ..obs.trace import process_tracer

        run_dir.mkdir(parents=True, exist_ok=True)
        # the engine's request spans land in the run dir, for run_report's
        # Serving and Capacity panels
        tracing = process_tracer(run_dir / "trace.jsonl")
    with tracing:
        traffic = dict(seed=args.seed, window_s=window_s, process=args.process, burst_factor=args.burst_factor,
                       burst_dwell_s=args.burst_dwell_s, zipf_s=zipf_s, population=population,
                       store_adapters=store_adapters, slo_p99_s=slo, geometry_mix=mix, max_queue=args.max_queue,
                       topk=args.topk, device=device, adapter_batch=args.adapter_batch)
        if args.degrade:
            doc = run_degrade(args.rung, rates, metrics_port=args.metrics_port, deadline_s=args.deadline_s,
                              overload_rate_rps=args.overload_rate, **traffic)
            print(json.dumps({k: doc[k] for k in ("mode", "rung", "overload_rate_rps", "goodput_retention",
                                                  "off_goodput_retention", "on_p99_s", "on_not_resident_refusals",
                                                  "headline")}))
        else:
            from ..serve import OverloadConfig

            overload = (OverloadConfig(deadline_default_s=float(args.deadline_s or 0.0)) if args.overload
                        else None)
            engine, pop = build_engine(args.rung, store_adapters, metrics_port=args.metrics_port,
                                       max_queue=args.max_queue, overload=overload, device=device,
                                       adapter_batch=args.adapter_batch)
            engine.warmup([(int(b), None) for b, _ in mix])
            try:
                doc = run_sweep(args.rung, rates, engine=engine, pop=pop, deadline_s=args.deadline_s, **traffic)
            finally:
                engine.close()
            print(json.dumps({k: doc[k] for k in ("mode", "rung", "capacity_rps", "goodput_rps", "knee", "headline")}))
        payload = json.dumps(doc, indent=2) + "\n"
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(payload)
            print(f"[loadgen] {doc['mode']} artifact -> {args.out}", file=sys.stderr)
        if run_dir is not None:
            name = Path(args.out).name if args.out else ("DEGRADE_run.json" if args.degrade else "CAPACITY_run.json")
            (run_dir / name).write_text(payload)
        return 0


if __name__ == "__main__":
    sys.exit(main())
