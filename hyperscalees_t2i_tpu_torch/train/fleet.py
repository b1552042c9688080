"""Fleet training: W independent ES jobs through one program against one
resident base (port of ``hyperscalees_t2i_tpu/train/fleet.py``).

``train.trainer.make_fleet_step`` is the program: one CUDA graph per
(W, m, r) on the card, the jobs' θ, Δθ, prompt ids, keys and σ/c/lr rows its
inputs. This module owns what is around it:

- **admission**: a job joins only if it shares the cohort geometry
  (:data:`COHORT_FIELDS`; σ, lr_scale, seed, num_epochs and save_every are
  free, they enter as input values) and, when the memory gate is armed,
  only if the width it would run at fits. The gate is
  ``serve.admission.check_fit`` against ``resolve_hbm_budget`` (the card's
  memory, or ``hbm_budget_bytes``), armed by the bytes a width's program was
  measured to hold when it was built (``serve.admission.program_bytes``: the
  resident base plus the graph's pool and buffers) or by
  ``peak_bytes_hint`` before any build; unarmed (recorded, never refused)
  when either number is unknown, as on the CPU. A refused job raises
  :class:`FleetAdmissionError` at :meth:`FleetScheduler.submit`, before
  anything is built.
- **per-job checkpoint slots**: one ``resilience.checkpoints.CheckpointStore``
  per job at ``run_dir/jobs/<job_id>/`` (the slot format both packages
  restore from each other), restorable without the fleet.
- **fair share**: each tick advances the ``max_width`` active jobs with the
  lowest epoch (ties by join order), so epochs stay within one of each other.
- **join/leave at epoch boundaries**: :meth:`FleetScheduler.submit` and
  :meth:`FleetScheduler.leave` queue; membership changes at the next tick.

θ and Δθ of every job stay on the card between ticks. A tick copies to the
host only what the JAX scheduler writes: the scalars and reward rows of
the one read-back (``metrics.jsonl`` and the rows' digest), due slots, and
each job's θ for the job registry's content digest
(``serve.adapter_store.AdapterStore(budget_bytes=0)``).

Parity: a job's reward rows, θ′ and Δθ in the fleet are bitwise what the
port's solo step (``make_es_step``) gives for the same θ, Δθ, prompts and
key: every job runs the solo chunks, scoring and update with its σ and lr
as f32 inputs rounded once (``trainer.fleet_scalar_args``). That is tighter
than the JAX package's contract (bitwise rows, θ′ within rounding).

:func:`analyze_fleet_geometry` and :func:`fleet_fit_verdict` give the
offline verdict of a rung at a width. The JAX package reads XLA's compiled
memory analysis for it; the port builds the width's program once on the
device and takes the admission probe's measured bytes.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..es.sampling import epoch_key
from ..lora import stack_adapters
from ..obs.metrics import MetricsRegistry, get_registry
from ..parallel.pop_eval import make_population_evaluator
from ..resilience.checkpoints import CheckpointStore
from ..serve.adapter_store import AdapterStore
from ..serve.admission import check_fit, program_bytes, resident_bytes, resolve_hbm_budget
from ..utils.pytree import tree_map
from .logging import MetricsLogger
from .trainer import _init_theta, device_ids, es_draws, fleet_scalar_args, make_fleet_step, program_cache

# TrainConfig fields every job of one fleet step must share: they shape the
# program (shapes, chunking, knob routing) or enter it as constants. The
# per-job freedoms are {sigma, lr_scale, seed, num_epochs, run_dir,
# save_every}.
COHORT_FIELDS: Tuple[str, ...] = (
    "pop_size", "egg_rank", "antithetic", "member_batch", "promptnorm",
    "prompts_per_gen", "batches_per_gen", "reward_tile", "noise_dtype",
    "pop_fuse", "base_quant", "remat", "max_step_norm", "theta_max_norm",
    "quality",
)


class FleetAdmissionError(RuntimeError):
    """A job refused at admission (a cohort mismatch, a duplicate id, a
    memory no-fit), naming the job and why."""

    def __init__(self, job_id: str, reason: str, detail: str = ""):
        self.job_id = job_id
        self.reason = reason
        super().__init__(f"fleet admission REFUSED for job {job_id!r} ({reason})" + (f": {detail}" if detail else ""))


def cohort_mismatches(job_tc: Any, cohort_tc: Any) -> List[str]:
    """``"field: job=… cohort=…"`` for every cohort field that differs
    (empty: compatible)."""
    out = []
    for f in COHORT_FIELDS:
        a, b = getattr(job_tc, f, None), getattr(cohort_tc, f, None)
        if a != b:
            out.append(f"{f}: job={a!r} cohort={b!r}")
    return out


def job_lane_spans(width: int, pop_size: int) -> List[Tuple[int, int]]:
    """``(first lane, lanes)`` of each job on the flat (job, member) lane
    axis: job ``j`` owns ``[j·pop, (j+1)·pop)``."""
    if width < 1:
        raise ValueError(f"fleet width must be >= 1, got {width}")
    return [(j * pop_size, pop_size) for j in range(width)]


def reward_rows_digest(rows: Any) -> str:
    """sha256 of one job's ``[pop, B]`` combined reward rows as f32
    little-endian bytes in C order: the JAX package's digest of the same
    array."""
    if isinstance(rows, torch.Tensor):
        rows = rows.detach().to("cpu", torch.float32).numpy()
    a = np.ascontiguousarray(np.asarray(rows, np.float32))
    return hashlib.sha256(a.astype("<f4", copy=False).tobytes()).hexdigest()


def make_solo_reward_rows(backend: Any, reward_fn: Any, tc: Any) -> Callable[..., torch.Tensor]:
    """``rows(theta, flat_ids, key) → [pop, B]``: the solo step's front half
    (its key split, noise draw and population evaluator), eagerly, on the
    backend's device. The solo step does not return its rows; this does."""
    es_cfg = tc.es_config()
    pop = tc.pop_size
    eval_pop = make_population_evaluator(backend.generate_p, reward_fn, pop, es_cfg, tc.member_batch,
                                         reward_tile=tc.reward_tile, pop_fuse=tc.pop_fuse)

    def rows(theta: Any, flat_ids: Any, key: torch.Tensor) -> torch.Tensor:
        ids = device_ids(flat_ids, backend.device)
        with torch.inference_mode():
            noise, gen_noise = es_draws(backend, theta, key.to(backend.device), pop, es_cfg, ids.numel())
            return eval_pop(theta, noise, ids, gen_noise.to(torch.float32))["combined"]

    return rows


def parse_fleet_geometry(spec: str) -> Tuple[str, int]:
    """``RUNG:J`` → ``(rung, width)``."""
    parts = [p.strip() for p in spec.split(":") if p.strip()]
    if len(parts) != 2:
        raise ValueError(f"fleet geometry must be RUNG:J, got {spec!r}")
    try:
        width = int(parts[1])
    except ValueError:
        raise ValueError(f"fleet geometry J must be an integer, got {spec!r}") from None
    if width < 1:
        raise ValueError(f"fleet geometry J must be >= 1, got {spec!r}")
    return parts[0], width


def analyze_fleet_geometry(rung: str, width: int, device: DeviceLike = None,
                           opt_override: Optional[Dict[str, Any]] = None, seed: int = 0) -> Dict[str, Any]:
    """Build a Sana rung (``RUNG_PLAN``/``RUNG_OPT``, random weights) and its
    ``width``-job fleet program once, in a scratch cache, and return the
    ``site="fleet"`` record: the resident base's bytes, the program's
    measured bytes (``serve.admission.program_bytes``) and their sum as
    ``peak_bytes``."""
    from ..backends.sana_backend import build_train_backend
    from ..rungs import RUNG_PLAN, rung_opt
    from .config import TrainConfig

    if rung not in RUNG_PLAN:
        raise ValueError(f"unknown rung {rung!r} (have: {sorted(RUNG_PLAN)})")
    scale, pop, m, member_batch = RUNG_PLAN[rung]
    opt = rung_opt(rung)
    opt.update({k: v for k, v in (opt_override or {}).items() if v is not None})
    dev = resolve_device(device)
    backend, reward_fn = build_train_backend(scale, dev, base_quant=opt["base_quant"], seed=seed)
    tc = TrainConfig(pop_size=pop, prompts_per_gen=m, member_batch=member_batch, reward_tile=opt["reward_tile"],
                     noise_dtype=opt["noise_dtype"], tower_dtype=opt["tower_dtype"], pop_fuse=opt["pop_fuse"],
                     base_quant=opt["base_quant"], seed=seed)
    W = int(width)
    cache = program_cache(backend, dev)
    step = make_fleet_step(backend, reward_fn, tc, m, 1, W, dev, graphs=cache)
    theta = _init_theta(backend, tc, dev)
    stacked = stack_adapters([theta] * W)
    ids = device_ids([backend.step_info(0, m, 1).flat_ids] * W, dev)
    keys = torch.stack([epoch_key(seed, 0, dev)] * W)
    rows = fleet_scalar_args([tc] * W)
    base = resident_bytes(backend, dev)
    pool = (lambda: next(iter(cache.entries.values())).stats.pool_bytes) if cache.graphed else None
    _, used = program_bytes(step, (stacked, tree_map(torch.zeros_like, stacked), ids, keys, *rows), dev, pool)
    return {"site": "fleet", "label": f"fleet-{rung}-j{W}", "rung": rung, "fleet_width": W,
            "imgs_per_step": W * pop * m, "base_bytes": float(base), "program_bytes": float(used),
            "peak_bytes": float(base + used),
            "geometry": {"scale": scale, "pop": pop, "m": m, "r": 1, "member_batch": member_batch,
                         "fleet_width": W, **opt}}


def fleet_fit_verdict(rec: Dict[str, Any], hbm_budget_bytes: Optional[float] = None,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """``admitted`` / ``REFUSED`` / ``unverdicted`` (budget or peak unknown)
    for one :func:`analyze_fleet_geometry` record, through the serving
    admission gate."""
    from ..serve.admission import ServeAdmissionError

    budget, source = resolve_hbm_budget(hbm_budget_bytes, None if device is None else torch.device(device))
    peak = rec.get("peak_bytes")
    try:
        armed = check_fit(rec.get("label", "fleet"), peak, budget, source)
    except ServeAdmissionError as e:
        return {"verdict": "REFUSED", "peak_bytes": float(peak), "budget_bytes": float(budget),
                "budget_source": source, "detail": str(e)}
    return {"verdict": "admitted" if armed else "unverdicted",
            "peak_bytes": float(peak) if peak is not None else None,
            "budget_bytes": float(budget) if budget is not None else None, "budget_source": source}


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetJobSpec:
    """One job: its id and config. ``tc`` matches the scheduler's cohort on
    every :data:`COHORT_FIELDS` entry."""

    job_id: str
    tc: Any  # TrainConfig
    num_epochs: Optional[int] = None  # default: tc.num_epochs


class _Job:
    __slots__ = ("spec", "index", "theta", "prev_delta", "epoch", "end_epoch", "store", "done",
                 "leave_requested", "last_scalars", "rows_digest", "rows_digests", "admission")

    def __init__(self, spec: FleetJobSpec, index: int, theta: Any, store: CheckpointStore, epoch: int,
                 prev_delta: Any, admission: Dict[str, Any]):
        self.spec = spec
        self.index = index
        self.theta = theta
        self.prev_delta = prev_delta
        self.epoch = int(epoch)
        self.end_epoch = int(spec.num_epochs if spec.num_epochs is not None else spec.tc.num_epochs)
        self.store = store
        self.done = False
        self.leave_requested = False
        self.last_scalars: Dict[str, Any] = {}
        self.rows_digest: Optional[str] = None
        self.rows_digests: List[str] = []  # one per advanced epoch: [e] made the e → e+1 update
        self.admission = admission


class FleetScheduler:
    """Admission, fair-share ticks, per-job slots and telemetry of a fleet
    over one set-up backend and reward suite on ``device`` (``None``: the
    card; it must be the backend's).

    One program per active width (and plan): ``programs`` (a
    ``utils.graphs.GraphCache``) counts a new one under ``fleet_compiles``,
    and ``fleet_traces`` counts the Python runs of the program body (on the
    card its warm-up and capture; on the CPU, which has no graphs, every
    tick). Any job mix at a built width is an input change. Counters and
    gauges go to ``registry`` (default: the process-global one):
    ``fleet_submits``, ``fleet_admission_unarmed``, ``fleet_compiles``,
    ``fleet_traces``, ``fleet_leaves``, ``fleet_width``,
    ``fleet_active_jobs``, ``job<i>/epoch``, ``job<i>/opt_score_mean``.
    ``metrics.jsonl`` gets one line a tick with the JAX keys."""

    def __init__(self, backend: Any, reward_fn: Any, cohort_tc: Any, run_dir: Any, max_width: int = 4,
                 hbm_budget_bytes: Optional[float] = None, peak_bytes_hint: Optional[float] = None,
                 device: DeviceLike = None, registry: Optional[MetricsRegistry] = None):
        if max_width < 1:
            raise ValueError(f"max_width must be >= 1, got {max_width}")
        self.device = resolve_device(device)
        if self.device != backend.device:
            raise ValueError(f"FleetScheduler on {self.device}, but the backend lives on {backend.device}")
        self.backend = backend
        self.reward_fn = reward_fn
        self.cohort_tc = cohort_tc
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.max_width = int(max_width)
        self.hbm_budget_bytes = hbm_budget_bytes
        self.peak_bytes_hint = peak_bytes_hint
        self.registry = registry if registry is not None else get_registry()
        self.logger = MetricsLogger(self.run_dir)
        self.registry_store = AdapterStore(budget_bytes=0, registry=self.registry)
        self.programs = program_cache(backend, self.device, registry=self.registry, counter="fleet_compiles",
                                      gauge="fleet_programs")
        self._jobs: Dict[str, _Job] = {}
        self._pending: List[_Job] = []
        self._next_index = 0
        self._steps: Dict[Tuple[int, int, int], Callable] = {}
        self._peaks: Dict[int, float] = {}
        self._tick = 0

    # -- admission -------------------------------------------------------------

    def _admission_gate(self, job_id: str, prospective_width: int) -> Dict[str, Any]:
        budget, source = resolve_hbm_budget(self.hbm_budget_bytes, self.device)
        peak = self._peaks.get(prospective_width, self.peak_bytes_hint)
        try:
            armed = check_fit(f"fleet:{job_id}@w{prospective_width}", peak, budget, source)
        except Exception as e:  # ServeAdmissionError → the fleet's typed refusal
            raise FleetAdmissionError(job_id, "memory no-fit", str(e)) from e
        return {"armed": bool(armed), "peak_bytes": peak, "budget_bytes": budget, "budget_source": source,
                "width": prospective_width}

    def submit(self, spec: FleetJobSpec, theta: Any = None, resume: bool = False) -> Dict[str, Any]:
        """Queue a job for the next tick boundary. A duplicate id, a cohort
        mismatch or a memory no-fit raises now, so a refused job never half
        joins. θ₀ is the trainer's (``fold_in(PRNGKey(seed), 17)``), or
        ``theta``; ``resume`` starts from the job's newest slot. Returns the
        admission record."""
        if spec.job_id in self._jobs or any(p.spec.job_id == spec.job_id for p in self._pending):
            raise FleetAdmissionError(spec.job_id, "duplicate job id")
        mism = cohort_mismatches(spec.tc, self.cohort_tc)
        if mism:
            raise FleetAdmissionError(spec.job_id, "cohort geometry mismatch", "; ".join(mism))
        n_after = sum(1 for j in self._jobs.values() if not j.done) + len(self._pending) + 1
        admission = self._admission_gate(spec.job_id, min(self.max_width, n_after))
        store = CheckpointStore(self.run_dir / "jobs" / spec.job_id, keep=max(1, getattr(spec.tc, "ckpt_keep", 3)))
        dev = self.device
        if theta is None:
            theta = _init_theta(self.backend, spec.tc, dev)
        epoch, prev_delta = 0, None
        if resume:
            res = store.restore(theta, with_delta=True)
            if res is not None:
                theta, epoch, prev_delta = res.theta, res.epoch, res.prev_delta
        theta = tree_map(lambda t: t.to(dev), theta)
        prev_delta = (tree_map(lambda t: t.to(dev), prev_delta) if prev_delta is not None
                      else tree_map(torch.zeros_like, theta))
        job = _Job(spec, self._next_index, theta, store, epoch, prev_delta, admission)
        self._next_index += 1
        self._pending.append(job)
        if self.registry_store.template is None:
            self.registry_store.template = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), theta)
        self.registry.inc("fleet_submits")
        if not admission["armed"]:
            self.registry.inc("fleet_admission_unarmed")
        self.logger.info(f"fleet: job {spec.job_id!r} admitted (index {job.index}, epoch {epoch}, gate "
                         f"{'armed' if admission['armed'] else 'unarmed'}) — joins at the next tick boundary")
        return admission

    def leave(self, job_id: str) -> None:
        """Request a leave, effective at the next tick boundary (a final
        slot is saved)."""
        if job_id not in self._jobs:
            raise KeyError(f"unknown fleet job {job_id!r}")
        self._jobs[job_id].leave_requested = True

    # -- the tick --------------------------------------------------------------

    def _boundary(self) -> None:
        for job in self._pending:
            self._jobs[job.spec.job_id] = job
            self.registry_store.put(job.spec.job_id, job.theta, source="fleet-join")
        self._pending.clear()
        for job in self._jobs.values():
            if job.done:
                continue
            if job.epoch >= job.end_epoch or job.leave_requested:
                self._save_job(job)
                job.done = True
                self.registry.inc("fleet_leaves")
                self.logger.info(f"fleet: job {job.spec.job_id!r} left at epoch boundary {job.epoch} "
                                 f"({'finished' if job.epoch >= job.end_epoch else 'requested'})")

    def _save_job(self, job: _Job) -> None:
        job.store.save(job.theta, job.epoch, prev_delta=job.prev_delta,
                       summary_reward=float(job.last_scalars.get("reward/combined_mean", 0.0) or 0.0),
                       backend_name=self.backend.name, config=dataclasses.asdict(job.spec.tc),
                       topology={"fleet_width": self.max_width, "fleet_job": job.spec.job_id,
                                 "pop_size": job.spec.tc.pop_size})

    def _run_step(self, W: int, m: int, r: int, args: Tuple[Any, ...]) -> Any:
        """The (W, m, r) program on ``args``; a new width's first call is its
        build, measured for the admission gate."""
        key = (W, m, r)
        step = self._steps.get(key)
        traces = 0 if step is None else step.traces
        if step is None:
            step = self._steps[key] = make_fleet_step(self.backend, self.reward_fn, self.cohort_tc, m, r, W,
                                                      self.device, graphs=self.programs)
            entry = ("fleet", W, m, r)
            pool = ((lambda: self.programs.entries[entry].stats.pool_bytes) if self.programs.graphed else None)
            out, used = program_bytes(step, args, self.device, pool)
            self._peaks[W] = float(resident_bytes(self.backend, self.device) + used)
        else:
            out = step(*args)
        self.registry.inc("fleet_traces", step.traces - traces)
        return out

    def tick(self) -> bool:
        """One fair-share step: membership changes at the boundary, the
        ``max_width`` lowest-epoch active jobs advance one epoch through the
        fleet program, per-job telemetry and due slots follow. False when no
        job is active."""
        self._boundary()
        active = [j for j in self._jobs.values() if not j.done]
        if not active:
            return False
        selected = sorted(active, key=lambda j: (j.epoch, j.index))[: self.max_width]
        W = len(selected)
        infos = [self.backend.step_info(j.epoch, j.spec.tc.prompts_per_gen, j.spec.tc.batches_per_gen)
                 for j in selected]
        geoms = {(len(i.unique_ids), i.repeats) for i in infos}
        if len(geoms) != 1:
            raise RuntimeError(f"fleet cohort produced divergent step geometries {geoms} — "
                               "prompts_per_gen/batches_per_gen must be cohort-uniform")
        (m, r), = geoms
        dev = self.device
        stacked = stack_adapters([j.theta for j in selected])
        sdelta = stack_adapters([j.prev_delta for j in selected])
        ids = device_ids([f for i in infos for f in i.flat_ids], dev).reshape(W, -1)
        keys = torch.stack([epoch_key(j.spec.tc.seed, j.epoch, dev) for j in selected])
        rows_args = tuple(torch.from_numpy(x).to(dev) for x in fleet_scalar_args([j.spec.tc for j in selected]))
        theta_new, delta, metrics, _opt = self._run_step(W, m, r, (stacked, sdelta, ids, keys, *rows_args))
        # the tick's one read-back: scalars and reward rows in one copy
        # (float64 holds every f32 and count exactly; a metric the step
        # returns as a host constant, such as an unused cap's scale, joins
        # on the device first)
        flat = torch.cat([v.reshape(-1).to(dev, torch.float64) for v in metrics.values()]).cpu()
        host = dict(zip(metrics, (part.reshape(v.shape) for part, v in
                                  zip(flat.split([v.numel() for v in metrics.values()]), metrics.values()))))
        rows = host.pop("fleet_reward_rows").to(torch.float32).numpy()  # [W, pop, B]

        reg = self.registry
        reg.gauge("fleet_width", W)
        reg.gauge("fleet_active_jobs", len(active))
        # "epoch" is the tick: report tooling keys rows on it; the jobs'
        # epochs are job<i>/epoch
        line: Dict[str, Any] = {"epoch": self._tick, "fleet_tick": self._tick, "fleet_width": W}
        for j, job in enumerate(selected):
            # θ and Δθ stay on the card, out of the graph's buffers
            job.theta = tree_map(lambda t, _j=j: t[_j].clone(), theta_new)
            job.prev_delta = tree_map(lambda t, _j=j: t[_j].clone(), delta)
            job.epoch += 1
            job.rows_digest = reward_rows_digest(rows[j])
            job.rows_digests.append(job.rows_digest)
            prefix = f"job{job.index}"
            scalars = {k: float(v[j]) for k, v in host.items() if v.ndim == 1 and v.shape[0] == W}
            job.last_scalars = scalars
            for k, v in scalars.items():
                line[f"{prefix}/{k}"] = v
            line[f"{prefix}/epoch"] = job.epoch
            line[f"{prefix}/job_id"] = job.spec.job_id
            line[f"{prefix}/reward_rows_sha256"] = job.rows_digest
            reg.gauge(f"{prefix}/epoch", job.epoch)
            if "opt_score_mean" in scalars:
                reg.gauge(f"{prefix}/opt_score_mean", scalars["opt_score_mean"])
            self.registry_store.put(job.spec.job_id, job.theta, source="fleet-tick")
            every = getattr(job.spec.tc, "save_every", 0)
            if every and job.epoch % every == 0:
                self._save_job(job)
        self.logger.log(self._tick, line)
        self._tick += 1
        return True

    def run(self, max_ticks: Optional[int] = None) -> int:
        """Tick until the fleet drains (or ``max_ticks``); returns the ticks
        run."""
        n = 0
        while (max_ticks is None or n < max_ticks) and self.tick():
            n += 1
        return n

    # -- introspection ---------------------------------------------------------

    def job_state(self, job_id: str) -> Dict[str, Any]:
        j = self._jobs[job_id]
        return {"job_id": job_id, "index": j.index, "epoch": j.epoch, "end_epoch": j.end_epoch, "done": j.done,
                "rows_digest": j.rows_digest, "rows_digests": list(j.rows_digests), "admission": j.admission,
                "scalars": dict(j.last_scalars)}

    def job_theta(self, job_id: str) -> Tuple[Any, Any]:
        """A job's current ``(θ, Δθ)`` on the device (the scheduler's own
        tensors: clone to change them)."""
        j = self._jobs[job_id]
        return j.theta, j.prev_delta

    def restore_job(self, job_id: str, theta_template: Any) -> Any:
        """A job's newest slot, read as a plain ``CheckpointStore`` at
        ``run_dir/jobs/<job_id>`` (no fleet state needed)."""
        return CheckpointStore(self.run_dir / "jobs" / job_id).restore(theta_template, with_delta=True)


__all__ = [
    "COHORT_FIELDS", "FleetAdmissionError", "FleetJobSpec", "FleetScheduler", "analyze_fleet_geometry",
    "cohort_mismatches", "fleet_fit_verdict", "job_lane_spans", "make_solo_reward_rows", "parse_fleet_geometry",
    "reward_rows_digest",
]
