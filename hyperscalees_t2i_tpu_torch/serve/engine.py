"""ServeEngine: multi-tenant LoRA inference over one resident frozen base.

Port of ``hyperscalees_t2i_tpu/serve/engine.py``:

- adapters are registered in an :class:`~.adapter_store.AdapterStore` and
  enter each dispatch as a lane-stacked batch (``lora.stack_adapters``);
- requests sharing a geometry (prompt count, guidance) coalesce up to
  ``adapter_batch`` lanes (``serve/batcher.py``);
- a batch runs through :func:`~..parallel.pop_eval.make_adapter_batch_generator`
  under ``torch.inference_mode()`` as one program per serving geometry
  (adapter lanes × images per request × guidance), the JAX engine's AOT
  pool: on the card a CUDA graph (``utils.graphs``), captured at the
  geometry's first dispatch (or :meth:`ServeEngine.warmup`) and replayed
  for every batch after. Adapters, prompt ids and keys are its inputs, so
  a new tenant is a new argument value and the capture count
  (``serve_compiles``) stays flat. A guidance other than the backend's is
  a cached copy of the backend with that guidance (its modules shared);
- a partial batch pads to ``adapter_batch`` lanes with slot 0's adapter,
  prompt ids and key, and drops the padded lanes' images
  (``serve_padded_slots`` counts them), the JAX engine's convention;
- **admission** (``serve/admission.py``): before a geometry's program is
  built, its memory is estimated from the same program at fewer lanes (1
  and 2, each below ``adapter_batch``) and checked against the budget (the
  card's memory unless ``hbm_budget_bytes`` overrides it); a no-fit raises
  :class:`~.admission.ServeAdmissionError` before anything runs at full
  width, and a fitting geometry records its measured bytes beside the
  estimate (``stats()["admission"]``). At ``adapter_batch`` 1 there is
  nothing smaller to probe: the gate checks the build's measured bytes
  and drops the program on a no-fit;
- **overload** (``ServeConfig.overload``, ``serve/overload.py``):
  deadlines with doomed-work shedding, a residency lease per accepted
  request, the brownout ladder and a per-adapter circuit breaker; off by
  default;
- **telemetry**: decomposed latency histograms (``serve_queue_wait_seconds``,
  ``serve_batch_assembly_seconds``, ``serve_dispatch_seconds``,
  ``serve_request_latency_seconds``), request and error counters, queue and
  occupancy gauges on ``engine.registry``; a ``serve/request`` trace event
  per request (``request_id``, adapter sha, geometry, queue position and
  the latency terms); ``metrics_port`` starts the ``/metrics`` +
  ``/healthz`` exporter and ``slo`` the burn-rate evaluator. A telemetry
  failure is retried, then dropped and counted (``serve_obs_dropped``): it
  never fails a request;
- **profile window** (``profile_dir``): ``torch.profiler`` over the first
  ``profile_batches`` dispatches (opened at the first dispatch, so a
  warm-up stays out), its Chrome trace written under ``profile_dir``
  (``obs/profile_trace.py`` reads it) when the window closes or at
  :meth:`ServeEngine.close`. A profiler that does not start fails the
  dispatch (the JAX engine warns and serves on unprofiled).

``compile_cache_dir`` (a CUDA graph cannot be serialized) is refused.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backends.base import GeneratorBackend
from ..device import DeviceLike, resolve_device
from ..lora import stack_adapters
from ..obs.metrics import MetricsRegistry
from ..obs.profile_trace import start_profile, stop_profile
from ..obs.trace import Tracer
from ..parallel.pop_eval import make_adapter_batch_generator
from ..utils import threefry
from ..utils.graphs import GraphCache
from ..utils.pytree import tree_map
from .adapter_store import AdapterStore, validate_adapter_tree
from .admission import (ServeAdmissionError, ServeShedError, check_fit, extrapolate, probe_lanes, program_bytes,
                        remember_estimate, remembered_estimate, resident_bytes, resolve_hbm_budget)
from .batcher import QueueFullError, RequestQueue, ServeRequest, ServeResult
from .overload import OverloadConfig, OverloadGovernor

Adapter = Any

# (field, is it set?, why the port refuses it)
_REFUSED = (
    ("compile_cache_dir", lambda v: v is not None,
     "a CUDA graph cannot be serialized; each process captures its own programs"),
)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """``adapter_batch``: lanes per dispatch; ``images_per_request``: the
    default request shape warmed by :meth:`ServeEngine.warmup`;
    ``member_batch``: lanes per chunk inside a dispatch (0 = all);
    ``adapter_budget_bytes``: the store's working set (0 = unbounded);
    ``hbm_budget_bytes``: the admission budget (None = the card's memory;
    on the CPU the gate is then unarmed); ``metrics_port``: serve
    ``/metrics`` and ``/healthz`` on this port (0 = off) at
    ``metrics_host``; ``slo``: objectives in the ``obs/slo.py`` grammar,
    evaluated after every dispatch; ``profile_dir``: trace the first
    ``profile_batches`` dispatches into this directory (None = off);
    ``overload``: the overload layer (None = off); ``device``: ``None`` =
    the CUDA card."""

    adapter_batch: int = 4
    images_per_request: int = 1
    member_batch: int = 0
    max_queue: int = 1024
    adapter_budget_bytes: int = 0
    hbm_budget_bytes: Optional[int] = None
    compile_cache_dir: Optional[str] = None
    metrics_port: int = 0
    metrics_host: str = "0.0.0.0"
    slo: Optional[str] = None
    profile_dir: Optional[str] = None
    profile_batches: int = 8
    overload: Optional[OverloadConfig] = None
    device: DeviceLike = None

    def __post_init__(self):
        bad = [f"{name}={getattr(self, name)!r} ({why})" for name, on, why in _REFUSED if on(getattr(self, name))]
        if bad:
            raise NotImplementedError("ServeConfig fields the port does not take: " + "; ".join(bad))


class ServeEngine:
    """Owns the adapter store, the request queue and one program per request
    geometry over a set-up backend. ``graph=False`` runs the programs
    eagerly on the card (A/B timing); ``theta_template`` is the adapter
    structure every tenant must match (default: the backend's
    ``init_theta``); ``tracer`` receives the request spans (default: one
    that writes nothing)."""

    def __init__(
        self,
        backend: GeneratorBackend,
        cfg: Optional[ServeConfig] = None,
        graph: bool = True,
        theta_template: Optional[Adapter] = None,
        tracer: Optional[Tracer] = None,
    ):
        self.backend = backend
        self.cfg = cfg or ServeConfig()
        if self.cfg.adapter_batch < 1:
            raise ValueError(f"adapter_batch must be >= 1, got {self.cfg.adapter_batch}")
        self.device = resolve_device(self.cfg.device)
        if backend.device != self.device:
            raise ValueError(f"backend is on {backend.device}, the engine on {self.device}")
        # serve_* counters, gauges and histograms under the JAX names
        self.registry = MetricsRegistry(prefix="")
        self.tracer = tracer if tracer is not None else Tracer(None)
        # the adapter structure every tenant must match (identity at init)
        if theta_template is None:
            theta_template = backend.init_theta(threefry.prng_key(0, self.device))
        self.template = theta_template
        self.store = AdapterStore(self.cfg.adapter_budget_bytes, template=theta_template, registry=self.registry)
        self.queue = RequestQueue(self.cfg.max_queue)
        # one program per (adapter lanes, images per request, guidance)
        self.programs = GraphCache(self.device, graph=graph, registry=self.registry, counter="serve_compiles",
                                   gauge="serve/programs_resident", tracer=self.tracer,
                                   span_attrs=lambda k: {"adapter_batch": k[0], "images_per_request": k[1],
                                                         "guidance": k[2]})
        # guidance -> a backend copy with that guidance (None: the backend's own)
        self._variants: Dict[Optional[float], Any] = {self.default_guidance_key(None): backend}
        self._budget, self._budget_source = resolve_hbm_budget(self.cfg.hbm_budget_bytes, self.device)
        # label -> the admission record (estimate, measured, budget)
        self.admission: Dict[str, Dict[str, Any]] = {}
        self._validated: set = set()
        self._undelivered: List[ServeResult] = []
        self._last_occupancy = 0.0
        self._hotness: Dict[str, int] = {}
        self._governor = OverloadGovernor(self.cfg.overload) if self.cfg.overload is not None else None
        self._not_resident = 0
        self.dispatch_seconds: List[float] = []
        # the profile window (cfg.profile_dir): opened at the first dispatch,
        # closed after cfg.profile_batches of them
        self._profiler = None
        self._profile_batches_seen = 0
        self.profile_trace: Optional[Path] = None
        self.exporter = None
        self._slo = None
        if self.cfg.slo:
            from ..obs.slo import build_serve_evaluator

            self._slo = build_serve_evaluator(self.cfg.slo, self.registry)
        if self.cfg.metrics_port:
            from ..obs.exporter import MetricsExporter
            from ..resilience.telemetry import get_resilience_registry

            registries = [self.registry, get_resilience_registry()]
            if self._slo is not None:
                registries.append(self._slo.registry)
            self.exporter = MetricsExporter(
                self.cfg.metrics_port, host=self.cfg.metrics_host, registries=registries,
                scalar_sources=[self.hotness_metrics, self.overload_metrics], healthz_source=self.health,
            ).start()

    def close(self) -> None:
        """Stop the exporter, if any, and write a still-open profile
        window's trace."""
        self._profile_stop()
        if self.exporter is not None:
            self.exporter.stop()
            self.exporter = None

    def _profile_start_maybe(self) -> None:
        """Open the window before the first dispatch; raises if the profiler
        does not start."""
        if not self.cfg.profile_dir or self._profiler is not None or self._profile_batches_seen:
            return
        self._profiler = start_profile(self.device)
        print(f"[serve] profiling the first {self.cfg.profile_batches} batches -> {self.cfg.profile_dir}",
              file=sys.stderr, flush=True)

    def _profile_batch_done(self) -> None:
        if self._profiler is None:
            return
        self._profile_batches_seen += 1
        if self._profile_batches_seen >= max(int(self.cfg.profile_batches), 1):
            self._profile_stop()

    def _profile_stop(self) -> None:
        if self._profiler is None:
            return
        prof, self._profiler = self._profiler, None
        self._profile_batches_seen = max(self._profile_batches_seen, 1)  # one window an engine
        name = f"serve_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.pt.trace.json"
        self.profile_trace = stop_profile(prof, Path(self.cfg.profile_dir) / name)
        print(f"[serve] profile window written -> {self.profile_trace}", file=sys.stderr, flush=True)

    def health(self) -> Dict[str, Any]:
        """The serve slice of ``/healthz``, with the overload layer's
        ``pressure`` view when it is armed."""
        out: Dict[str, Any] = {"serve": {
            "queue_depth": self.queue.depth,
            "batch_occupancy": self._last_occupancy,
            "programs_resident": len(self.programs.entries),
            "adapters_resident": self.store.stats().get("resident"),
            "undelivered_results": len(self._undelivered),
            "not_resident_refusals": self._not_resident,
        }}
        if self._governor is not None:
            out["pressure"] = self._governor.pressure_view(self.queue.depth, self.cfg.max_queue or 1024,
                                                           self.store.leases_active)
        return out

    def _safe_obs(self, fn: Callable, *args: Any, **kwargs: Any) -> None:
        """One telemetry emission: retried on transient I/O without sleeping;
        then, or on any other failure, dropped and counted."""
        from ..resilience.retry import call_with_retry

        try:
            call_with_retry(fn, args, kwargs, site="serve_obs", base_delay_s=0.0, max_delay_s=0.0)
        except Exception as e:
            try:
                self.registry.inc("serve_obs_dropped")
                print(f"[serve] WARNING: obs emission dropped ({e!r})", file=sys.stderr, flush=True)
            except Exception:
                pass

    # -- adapters ------------------------------------------------------------
    def put_adapter(self, adapter_id: str, theta: Adapter) -> str:
        """Register an in-memory adapter; returns its content version."""
        return self.store.put(adapter_id, theta).version

    def load_adapter(self, adapter_id: str, run_dir) -> str:
        """Register an adapter from a training run's checkpoint slots."""
        return self.store.load(adapter_id, run_dir, template=self.template).version

    # -- static generation-config variants (guidance) ------------------------
    @property
    def default_guidance(self) -> Optional[float]:
        return getattr(self.backend.cfg, "guidance_scale", None)

    def default_guidance_key(self, guidance: Optional[float]) -> Optional[float]:
        """``None`` for the backend's own guidance, else the float."""
        base = self.default_guidance
        return None if guidance is None or float(guidance) == base else float(guidance)

    def _variant(self, guidance: Optional[float]) -> Any:
        key = self.default_guidance_key(guidance)
        if key not in self._variants:
            if self.default_guidance is None:
                raise ValueError(f"backend {self.backend.name} has no guidance_scale knob; restart with the "
                                 "backend's guidance flags instead (--guidance_scale / --cfg_list)")
            # a shallow copy shares every module and table; only the cfg differs
            variant = copy.copy(self.backend)
            variant.cfg = dataclasses.replace(self.backend.cfg, guidance_scale=key)
            self._variants[key] = variant
        return self._variants[key]

    # -- programs ------------------------------------------------------------
    def _program(self, lanes: int, B: int, guidance: Optional[float]) -> Tuple[Tuple, str, Callable]:
        g_key = self.default_guidance_key(guidance)
        gen = make_adapter_batch_generator(self._variant(guidance).generate_p, lanes, B,
                                           member_batch=self.cfg.member_batch)
        label = f"serve_a{lanes}b{B}" + (f"_g{g_key:g}" if g_key is not None else "")
        return (lanes, B, g_key), label, gen

    def _inputs(self, thetas: Sequence[Adapter], ids: Sequence[Sequence[int]], seeds: Sequence[int]):
        stacked = tree_map(lambda t: t.to(self.device), stack_adapters(list(thetas)))
        ids_t = torch.tensor([list(i) for i in ids], dtype=torch.long).to(self.device)
        # a request's key is PRNGKey(seed); its image j folds j in (the JAX engine's)
        keys = torch.stack([threefry.prng_key(s, self.device) for s in seeds])
        return stacked, ids_t, keys

    def _probe(self, lanes: int, B: int, guidance: Optional[float]) -> int:
        """What the geometry's program holds above the resident base at
        ``lanes`` lanes (zero adapters), built in a scratch cache that
        counts nothing and is dropped after."""
        _key, _label, fn = self._program(lanes, B, guidance)
        cache = GraphCache(self.device, graph=self.programs.graphed)
        zeros = tree_map(torch.zeros_like, self.template)
        args = self._inputs([zeros] * lanes, [[0] * B] * lanes, [0] * lanes)
        pool = (lambda: cache.entries["probe"].stats.pool_bytes) if cache.graphed else None
        out, used = program_bytes(lambda *a: cache("probe", fn, *a), args, self.device, pool)
        del out, args
        cache.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return used

    def _geometry(self, B: int, guidance: Optional[float]) -> Tuple:
        """What an admission estimate is remembered under, per backend."""
        return (self.cfg.adapter_batch, B, self.default_guidance_key(guidance), self.cfg.member_batch,
                self.programs.graphed)

    def _admit(self, label: str, B: int, guidance: Optional[float]) -> Dict[str, Any]:
        """The fit gate of one new geometry, before its program is built:
        estimate (from probes below ``adapter_batch`` lanes, or this
        backend's remembered estimate), check, record. At ``adapter_batch``
        1 there is no probe: the record carries no estimate and :meth:`_run`
        checks the build's measured bytes."""
        A = self.cfg.adapter_batch
        rec: Dict[str, Any] = {"label": label, "budget_bytes": self._budget, "budget_source": self._budget_source,
                               "armed": False}
        self.admission[label] = rec
        if self._budget is None:
            return rec
        est = remembered_estimate(self.backend, self._geometry(B, guidance))
        if est is None and probe_lanes(A):
            probes = {n: self._probe(n, B, guidance) for n in probe_lanes(A)}
            est = {"probes": probes, "program_bytes": extrapolate(probes, A)}
            remember_estimate(self.backend, self._geometry(B, guidance), est)
        rec["base_bytes"] = resident_bytes(self.backend, self.device)
        if est is not None:
            rec.update(probe_bytes=dict(est["probes"]), estimate_program_bytes=est["program_bytes"],
                       estimate_bytes=rec["base_bytes"] + est["program_bytes"])
            rec["armed"] = check_fit(label, rec["estimate_bytes"], self._budget, self._budget_source)
        return rec

    def _run(self, thetas: Sequence[Adapter], ids: List[List[int]], seeds: List[int],
             guidance: Optional[float]) -> np.ndarray:
        """One dispatch of ``n ≤ adapter_batch`` requests, padded to
        ``adapter_batch`` lanes with slot 0's adapter, ids and seed; the
        padded lanes' images are dropped. A geometry's first call passes
        the admission gate, then builds its program."""
        n, A = len(thetas), self.cfg.adapter_batch
        lanes = list(range(n)) + [0] * (A - n)
        B = len(ids[0])
        key, label, fn = self._program(A, B, guidance)
        if key not in self.programs.entries:
            rec = self._admit(label, B, guidance)
            args = self._inputs([thetas[i] for i in lanes], [ids[i] for i in lanes], [seeds[i] for i in lanes])
            pool = (lambda: self.programs.entries[key].stats.pool_bytes) if self.programs.graphed else None
            out, used = program_bytes(lambda *a: self.programs(key, fn, *a), args, self.device, pool)
            if rec.get("base_bytes") is not None:
                rec.update(measured_program_bytes=used, measured_bytes=rec["base_bytes"] + used)
                if "estimate_bytes" not in rec:  # adapter_batch 1: the gate measures
                    remember_estimate(self.backend, self._geometry(B, guidance),
                                      {"probes": {}, "program_bytes": float(used)})
                    try:
                        rec["armed"] = check_fit(label, rec["measured_bytes"], self._budget, self._budget_source)
                    except ServeAdmissionError:
                        self.programs.drop(key)
                        raise
        else:
            args = self._inputs([thetas[i] for i in lanes], [ids[i] for i in lanes], [seeds[i] for i in lanes])
            out = self.programs(key, fn, *args)
        self.registry.inc("serve_padded_slots", A - n)
        return out[:n].to(torch.float32).cpu().numpy()

    def warmup(self, geometries: Optional[Sequence[Tuple[int, Optional[float]]]] = None) -> List[str]:
        """Admit, build and run each ``(images_per_request, guidance)``
        geometry once at full ``adapter_batch`` with zero adapters. Returns
        a label per geometry."""
        geoms = list(geometries) if geometries else [(self.cfg.images_per_request, None)]
        zeros = tree_map(torch.zeros_like, self.template)
        labels = []
        A = self.cfg.adapter_batch
        for B, g in geoms:
            with self.tracer.span("serve/warmup", images_per_request=B, guidance=g):
                self._run([zeros] * A, [[0] * B] * A, [0] * A, g)
            self.registry.inc("serve_warmups")
            labels.append(self._program(A, B, g)[1])
        return labels

    # -- request path --------------------------------------------------------
    def submit(self, adapter_id: str, prompt_ids: Sequence[int], seed: int, guidance: Optional[float] = None,
               t_submit: Optional[float] = None, priority: int = 1,
               deadline_s: Optional[float] = None) -> ServeRequest:
        """Enqueue one request. A non-resident adapter, an empty or
        out-of-range prompt list, a guidance the backend has no knob for and
        a full queue raise here, each counted in ``serve_request_errors``
        (a full queue also in ``serve_queue_rejected``, with its wait
        observed). ``t_submit`` (a ``time.perf_counter()`` value) backdates
        the arrival; ``deadline_s`` is relative to it. With the overload
        layer armed, a request is shed here (:class:`ServeShedError`) under
        brownout priority, an expired deadline or an open breaker; at rung
        2 it is truncated to ``degraded_images`` prompts; an accepted
        request leases its adapter until it is finalized."""
        req = ServeRequest(adapter_id=adapter_id, prompt_ids=tuple(int(i) for i in prompt_ids), seed=int(seed),
                           guidance=guidance)
        if t_submit is not None:
            req.t_submit = float(t_submit)
        req.priority = int(priority)
        gov = self._governor
        if deadline_s is None and gov is not None and gov.cfg.deadline_default_s > 0:
            deadline_s = gov.cfg.deadline_default_s
        if deadline_s is not None:
            req.t_deadline = req.t_submit + float(deadline_s)
        if gov is not None:
            if gov.rung >= 1 and req.priority < gov.cfg.shed_below_priority:
                self._shed_submit(req, "brownout_priority", censored=False)
            if req.t_deadline is not None and time.perf_counter() >= req.t_deadline:
                self._shed_submit(req, "deadline", censored=True)
            if not gov.breaker.allow(adapter_id):
                self._shed_submit(req, "breaker_open", censored=False)
            if gov.rung >= 2 and len(req.prompt_ids) > max(gov.cfg.degraded_images, 1):
                req.prompt_ids = req.prompt_ids[:max(gov.cfg.degraded_images, 1)]
                req.degraded = True
        try:
            entry = self.store.entry(adapter_id)  # KeyError for a non-resident adapter
            if guidance is not None:
                self._variant(guidance)
            if not req.prompt_ids:
                raise ValueError("a request needs at least one prompt id")
            bad = [i for i in req.prompt_ids if not 0 <= i < self.backend.num_items]
            if bad:
                raise ValueError(f"prompt ids {bad} outside the catalog of {self.backend.num_items}")
            self.queue.submit(req)
        except Exception as exc:
            rejected = isinstance(exc, QueueFullError)
            if gov is not None:
                gov.breaker.abort_probe(adapter_id)

            def refused() -> None:
                self.registry.inc("serve_request_errors")
                if rejected:
                    self.registry.inc("serve_queue_rejected")
                    self.registry.observe("serve_queue_wait_seconds", max(time.perf_counter() - req.t_submit, 0.0))
                if self._slo is not None:
                    self._slo.tick()

            self._safe_obs(refused)
            raise
        if gov is not None:
            self.store.lease(adapter_id)
        self._hotness[adapter_id] = self._hotness.get(adapter_id, 0) + 1

        def emit() -> None:
            with self.tracer.span("serve/submit", request_id=req.request_id, adapter=adapter_id,
                                  adapter_sha=entry.version, queue_position=req.queue_position,
                                  geometry=list(req.geometry_key)):
                pass
            self.registry.gauge("serve/queue_depth", self.queue.depth)

        self._safe_obs(emit)
        return req

    # -- overload layer --------------------------------------------------------
    def _finalize_request(self, r: ServeRequest, reason: str, censored_wait: bool = False) -> bool:
        """The request's terminal accounting, exactly once: the lease
        released, an undispatched breaker probe returned, a censored wait
        observed. Later calls are counted no-ops (``serve_finalize_duplicates``)."""
        if r.finalized:
            self._safe_obs(self.registry.inc, "serve_finalize_duplicates")
            return False
        r.finalized = True
        gov = self._governor
        if gov is not None:
            self.store.release(r.adapter_id)
            if reason not in ("complete", "fault"):
                gov.breaker.abort_probe(r.adapter_id)
        if censored_wait:
            self._safe_obs(self.registry.observe, "serve_queue_wait_seconds",
                           max(time.perf_counter() - r.t_submit, 0.0))
        return True

    def _shed_submit(self, req: ServeRequest, reason: str, censored: bool) -> None:
        gov = self._governor
        gov.count_shed(reason)
        req.finalized = True

        def emit() -> None:
            self.registry.inc("serve_request_errors")
            self.registry.inc("serve_shed_total")
            if censored:
                self.registry.observe("serve_queue_wait_seconds", max(time.perf_counter() - req.t_submit, 0.0))
            if self._slo is not None:
                self._slo.tick()

        self._safe_obs(emit)
        raise ServeShedError(reason, f"request {req.request_id} adapter {req.adapter_id!r} "
                                     f"(rung {gov.controller.rung_name})")

    def _shed_result(self, r: ServeRequest, reason: str) -> ServeResult:
        """Shed an accepted request: finalize, count, and an error result."""
        gov = self._governor
        if gov is not None:
            gov.count_shed(reason)
        t_now = time.perf_counter()
        self._finalize_request(r, reason="shed", censored_wait=True)

        def emit() -> None:
            self.registry.inc("serve_request_errors")
            self.registry.inc("serve_shed_total")
            if self._slo is not None:
                self._slo.tick()
            self.tracer.event("serve/request", r.t_submit, t_now, request_id=r.request_id, adapter=r.adapter_id,
                              shed=reason)

        self._safe_obs(emit)
        return ServeResult(request=r, images=None, latency_s=t_now - r.t_submit, batch_size=0,
                           batch_occupancy=0.0, error=f"shed ({reason})", shed_reason=reason, degraded=r.degraded)

    def _shed_doomed(self) -> List[ServeResult]:
        """Prune the queue of requests whose deadline passed or whose
        remaining budget is under their geometry's EWMA dispatch time."""
        gov = self._governor
        now = time.perf_counter()
        reasons: Dict[int, str] = {}

        def doomed(req: ServeRequest) -> bool:
            why = gov.doom_reason(req, now)
            if why is not None:
                reasons[req.request_id] = why
            return why is not None

        return [self._shed_result(r, reasons[r.request_id]) for r in self.queue.prune(doomed)]

    def _pressure_eval(self) -> None:
        """One brownout-ladder evaluation (queue depth, the SLO's fast burn,
        store evictions); rung changes are loud and counted."""
        gov = self._governor
        burn = self._slo.max_burn("fast") if self._slo is not None else None
        before = gov.rung
        rung = gov.evaluate(self.queue.depth, self.cfg.max_queue or 1024, burn, self.store.evictions)

        def emit() -> None:
            self.registry.gauge("serve/pressure_rung", rung)
            if rung != before:
                self.registry.inc("serve_brownout_transitions")

        self._safe_obs(emit)
        if rung != before:
            verb = "escalate" if rung > before else "recover"
            print(f"[serve] BROWNOUT {verb}: rung {before} -> {rung} ({gov.controller.rung_name}) signals="
                  f"{ {k: round(v, 3) for k, v in gov.controller.last.items()} }", file=sys.stderr, flush=True)

    def overload_metrics(self) -> Dict[str, Any]:
        """Exporter scalar source: lease occupancy and not-resident refusals;
        with the layer armed, the governor's shed, breaker and rung series."""
        out: Dict[str, Any] = {"serve/leases_active": self.store.leases_active,
                               "serve_not_resident_refusals": self._not_resident}
        if self._governor is not None:
            out.update(self._governor.metrics())
        return out

    def overload_snapshot(self) -> Dict[str, Any]:
        """Host-side counters for the load harness."""
        gov = self._governor
        return {
            "enabled": gov is not None,
            "rung": gov.rung if gov is not None else 0,
            "shed": dict(gov.shed) if gov is not None else {},
            "shed_total": gov.shed_total() if gov is not None else 0,
            "degraded_total": gov.degraded_total if gov is not None else 0,
            "not_resident_refusals": self._not_resident,
            "leases_active": self.store.leases_active,
            "lease_blocked_evictions": getattr(self.store, "lease_blocked", 0),
            "breakers_open": len(gov.breaker.non_closed()) if gov is not None else 0,
        }

    def _refuse_request(self, r: ServeRequest, exc: Exception) -> ServeResult:
        """One request fails alone (its adapter evicted or invalid); its
        batch mates dispatch."""
        t_now = time.perf_counter()

        def emit() -> None:
            self.registry.inc("serve_request_errors")
            self.registry.inc("serve_adapter_faults")
            if self._slo is not None:
                self._slo.tick()
            self.tracer.event("serve/request", r.t_submit, t_now, request_id=r.request_id, adapter=r.adapter_id,
                              error=repr(exc))

        self._safe_obs(emit)
        print(f"[serve] REFUSED request {r.request_id} (adapter {r.adapter_id!r}): {exc}", file=sys.stderr,
              flush=True)
        return ServeResult(request=r, images=None, latency_s=t_now - r.t_submit, batch_size=0, batch_occupancy=0.0,
                           error=str(exc))

    def _dispatch(self, batch: List[ServeRequest]) -> List[ServeResult]:
        gov = self._governor
        A = self.cfg.adapter_batch
        t_assemble0 = time.perf_counter()
        refused: List[ServeResult] = []
        good: List[ServeRequest] = []
        thetas, versions = [], []
        for r in batch:
            if gov is not None:
                why = gov.doom_reason(r, t_assemble0)
                if why is not None:
                    refused.append(self._shed_result(r, why))
                    continue
            try:
                store_entry = self.store.entry(r.adapter_id)
                version = store_entry.version
                if (r.adapter_id, version) not in self._validated:
                    validate_adapter_tree(r.adapter_id, store_entry.theta, self.template)
                    if len(self._validated) >= 4096:
                        self._validated.clear()
                    self._validated.add((r.adapter_id, version))
                theta = self.store.get(r.adapter_id)
            except Exception as exc:
                if isinstance(exc, KeyError):
                    # admitted at submit, not resident at dispatch (0 with leases)
                    self._not_resident += 1
                    self._safe_obs(self.registry.inc, "serve_not_resident_refusals")
                if gov is not None:
                    gov.breaker.record_fault(r.adapter_id)
                refused.append(self._refuse_request(r, exc))
                self._finalize_request(r, reason="fault")
                continue
            good.append(r)
            versions.append(version)
            thetas.append(theta)
        if not good:
            return refused
        n = len(good)
        occupancy = n / A
        assembly_s = time.perf_counter() - t_assemble0
        try:
            self._profile_start_maybe()
            with self.tracer.span("serve/batch", requests=n, occupancy=occupancy,
                                  request_ids=[r.request_id for r in good]):
                t_disp0 = time.perf_counter()
                images = self._run(thetas, [list(r.prompt_ids) for r in good], [r.seed for r in good],
                                   good[0].guidance)
                dispatch_s = time.perf_counter() - t_disp0
        except Exception:
            # a failed dispatch fails every request of the batch; no breaker
            # food (no per-adapter attribution); leases released once
            def failed() -> None:
                self.registry.inc("serve_request_errors", n)
                if self._slo is not None:
                    self._slo.tick()

            self._safe_obs(failed)
            for r in good:
                self._finalize_request(r, reason="fault")
            raise
        t_done = time.perf_counter()
        self._profile_batch_done()
        self.dispatch_seconds.append(t_done - t_disp0)
        self._last_occupancy = occupancy
        n_degraded = sum(1 for r in good if r.degraded)
        if gov is not None:
            gov.ewma.observe(good[0].geometry_key, dispatch_s)
            gov.degraded_total += n_degraded
        results = []
        for i, r in enumerate(good):
            if gov is not None:
                gov.breaker.record_ok(r.adapter_id)
            self._finalize_request(r, reason="complete")
            results.append(ServeResult(request=r, images=images[i], latency_s=t_done - r.t_submit, batch_size=n,
                                       batch_occupancy=occupancy, adapter_version=versions[i], degraded=r.degraded))

        def emit() -> None:
            reg = self.registry
            reg.inc("serve_dispatches")
            reg.inc("serve_requests", n)
            reg.inc("serve_images", n * images.shape[1])
            if n_degraded:
                reg.inc("serve_degraded_total", n_degraded)
            reg.gauge("serve/batch_occupancy", occupancy)
            reg.gauge("serve/queue_depth", self.queue.depth)
            reg.observe("serve_batch_assembly_seconds", assembly_s)
            reg.observe("serve_dispatch_seconds", dispatch_s)
            for i, r in enumerate(good):
                queue_wait = max((r.t_dequeue or t_assemble0) - r.t_submit, 0.0)
                reg.observe("serve_queue_wait_seconds", queue_wait)
                reg.observe("serve_request_latency_seconds", results[i].latency_s)
                self.tracer.event("serve/request", r.t_submit, t_done, parent="serve/batch",
                                  request_id=r.request_id, adapter=r.adapter_id, adapter_sha=versions[i],
                                  geometry=list(r.geometry_key), batch_size=n, occupancy=occupancy,
                                  queue_position=r.queue_position, queue_wait_s=round(queue_wait, 6),
                                  assembly_s=round(assembly_s, 6), dispatch_s=round(dispatch_s, 6))

        self._safe_obs(emit)
        if self._slo is not None:
            self._safe_obs(self._slo.tick)
        return refused + results

    def flush(self, max_batches: Optional[int] = None) -> List[ServeResult]:
        """Coalesce and dispatch queued requests until the queue is empty (or
        ``max_batches`` dispatches); also delivers results that an earlier
        :meth:`generate` call served for other requests. With the overload
        layer armed, each iteration first sheds doomed requests (their
        results come back too) and evaluates the brownout ladder."""
        results: List[ServeResult] = list(self._undelivered)
        self._undelivered.clear()
        dispatched = 0
        while self.queue.depth:
            if max_batches is not None and dispatched >= max_batches:
                break
            if self._governor is not None:
                results.extend(self._shed_doomed())
                self._pressure_eval()
                if not self.queue.depth:
                    break
            with self.tracer.span("serve/coalesce", queue_depth=self.queue.depth):
                batch = self.queue.take_batch(self.cfg.adapter_batch)
            if not batch:
                break
            results.extend(self._dispatch(batch))
            dispatched += 1
        return results

    def abandon_queued(self) -> List[ServeRequest]:
        """Drain the queue without dispatching (end of a load window,
        shutdown): each request's censored wait is observed and its lease
        released, once; ``serve_queue_abandoned`` counts them."""
        abandoned = self.queue.drain()
        if not abandoned:
            return abandoned

        def emit() -> None:
            self.registry.inc("serve_queue_abandoned", len(abandoned))
            self.registry.gauge("serve/queue_depth", self.queue.depth)

        self._safe_obs(emit)
        for r in abandoned:
            self._finalize_request(r, reason="abandon", censored_wait=True)
        return abandoned

    # -- hot adapters ----------------------------------------------------------
    def hot_adapters(self, k: int = 10) -> List[Tuple[str, int]]:
        """Top ``k`` adapters by accepted requests, hottest first."""
        return sorted(self._hotness.items(), key=lambda kv: (-kv[1], kv[0]))[:k]

    def hotness_metrics(self, k: int = 10) -> Dict[str, Any]:
        """Exporter scalar source: the top-K as one labeled series plus the
        count of distinct adapters seen (bounded cardinality)."""
        out: Dict[str, Any] = {"serve/adapters_seen": len(self._hotness)}
        hot = self.hot_adapters(k)
        if hot:
            out["serve_adapter_hotness"] = {"labeled": [({"adapter": aid}, n) for aid, n in hot]}
        return out

    def generate(self, adapter_id: str, prompt_ids: Sequence[int], seed: int,
                 guidance: Optional[float] = None) -> np.ndarray:
        """Submit one request, flush, and return its images ``[B, H, W, C]``;
        other queued requests ride along and are delivered by the next
        :meth:`flush`."""
        req = self.submit(adapter_id, prompt_ids, seed, guidance)
        mine: Optional[ServeResult] = None
        for res in self.flush():
            if res.request.request_id == req.request_id:
                mine = res
            else:
                self._undelivered.append(res)
        if mine is None:
            raise RuntimeError("flush completed without serving the request")
        if mine.error is not None:
            raise RuntimeError(f"request {req.request_id} refused (adapter {adapter_id!r}): {mine.error}")
        return mine.images

    # -- introspection ---------------------------------------------------------
    def latency_percentiles(self) -> Optional[Dict[str, float]]:
        """p50/p95/p99 from the request-latency histogram (one-bucket
        resolution; None before any request)."""
        h = self.registry.histogram("serve_request_latency_seconds")
        if not h.count:
            return None
        from ..utils.stats import histogram_percentiles

        return histogram_percentiles(h.bounds, h.cumulative())

    def stats(self) -> Dict[str, Any]:
        """The engine's state; ``requests``, ``dispatches``, ``refused`` and
        ``images`` read the registry's ``serve_requests``,
        ``serve_dispatches``, ``serve_adapter_faults`` and ``serve_images``."""
        reg = self.registry
        return {
            "requests": reg.value("serve_requests", 0),
            "dispatches": reg.value("serve_dispatches", 0),
            "refused": reg.value("serve_adapter_faults", 0),
            "images": reg.value("serve_images", 0),
            "dispatch_seconds": list(self.dispatch_seconds),
            "queue_depth": self.queue.depth,
            "device": str(self.device),
            "store": self.store.stats(),
            **self.registry.snapshot(),
            "programs": self.programs.stats(),
            "latency": self.latency_percentiles(),
            "admission": {k: dict(v) for k, v in self.admission.items()},
            "hbm_budget_bytes": self._budget,
            "hbm_budget_source": self._budget_source,
        }


__all__ = [
    "OverloadConfig",
    "ServeAdmissionError",
    "ServeConfig",
    "ServeEngine",
    "ServeShedError",
]
