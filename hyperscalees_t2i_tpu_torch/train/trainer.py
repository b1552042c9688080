"""The EGGROLL-ES epoch step and the training loop around it (port of
``_combine_and_update``, ``make_es_step`` and the single-process core of
``run_training`` from ``hyperscalees_t2i_tpu/train/trainer.py``).

One step: draw the factored ES noise and the epoch's generation noise,
evaluate every member (perturb → generate → decode → reward, in chunks of
``member_batch``), build the ``[pop, B]`` reward rows, then promptnorm,
masked standardization, the EGGROLL update, the step cap and the θ cap.
Every member shares the epoch's generation noise (common random numbers).

Keys: as in the JAX package, the step splits its epoch key
(``es.sampling.epoch_key(seed, epoch)``) into a noise key and a generation
key (:func:`es_draws`, inside the step), and θ₀ is drawn from
``fold_in(PRNGKey(seed), 17)``: the same seed draws the JAX package's
numbers (``utils.threefry``), on the step's device. ``noise=``/``gen_noise=``
take given draws instead.

The step is one program (``utils.graphs``): on the card a CUDA graph per
(m, r) plan, captured at its first call and replayed after, as the JAX
package dispatches one AOT program per plan. ES needs no gradient: it runs
under ``torch.inference_mode()``.

:func:`run_training` is the loop: one dispatch per epoch, or a chain of
``steps_per_dispatch`` replays with one read-back (the JAX loop's chained
dispatch), ``metrics.jsonl``, ``quality.jsonl``, checkpoint slots and
resume, the non-finite rollback, SIGTERM/SIGINT preemption. Its θ₀ comes
from :func:`_init_theta` and each epoch's draws from :func:`es_draws`, so a
test can put the JAX package's draws in their place. Its live telemetry is
the JAX loop's: ``/metrics`` and ``/healthz`` (``tc.metrics_port``), SLOs
(``tc.slo``), heartbeats around the compile (warm-up and capture),
dispatch and checkpoint phases with the stall watchdog, and the ES-health
anomaly watchdog. Its artifacts are the JAX loop's too: θ/Δθ histograms
and the population's scores in the rows (``tc.log_hist_every``), the
best/median/worst member strips (``tc.log_images_every``) and the best
member's snapshot grid (``tc.snapshot_every``), each member regenerated
from (seed, epoch, member) (:func:`regenerate_member_images`), the program
ledger ``programs.jsonl`` (``obs.program_cost``: each plan's FLOPs and
bytes counted over its warm-up epoch), ``mfu`` and the ``roofline/*``
verdict per dispatch, the ``torch.profiler`` window of the first
``tc.profile_epochs`` epochs with its calibration ``CALIB_train.json``
(``obs.calib``), and ``QUALITY_train.json`` at the run's end. The pod
machinery of the JAX loop (host-sharded programs, coordinated commit,
elastic membership, the desync check, fault injection) is not here;
``train.config.unported_settings`` names the ROADMAP item of each.

:func:`make_fleet_step` advances W independent jobs in one program
(``train.fleet`` schedules them).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..es.caps import cap_step_norm, cap_theta_norm, global_norm
from ..es.noiser import es_update, lane_slice, perturb_member, sample_noise
from ..es.sampling import epoch_key
from ..es.scoring import prompt_normalized_scores, standardize_fitness_masked
from ..lora import stack_adapters
from ..obs.anomaly import AnomalyWatchdog
from ..obs.es_health import DegeneracyWatchdog, es_health_metrics
from ..obs.exporter import maybe_exporter, note_health, reset_health
from ..obs.heartbeat import device_memory_gauges, emit_heartbeat, maybe_heartbeat
from ..obs.metrics import MetricsRegistry, record_device_memory
from ..obs.profile_trace import start_profile, stop_profile
from ..obs.program_cost import ProgramLedger, record_program, roofline, set_ledger
from ..obs.quality import QualityLedger, quality_metrics
from ..obs.slo import build_trainer_evaluator
from ..obs.trace import Tracer
from ..parallel.pop_eval import make_fleet_evaluator, make_population_evaluator
from ..resilience.checkpoints import CheckpointStore
from ..resilience.preempt import HALT_MARKER, PREEMPT_MARKER, PreemptionHandler, write_marker
from ..resilience.rollback import RollbackController
from ..resilience.telemetry import host_snapshot_payload
from ..utils import threefry
from ..utils.graphs import GraphCache
from ..utils.images import make_prompt_strip, resize_lanczos, to_uint8, write_png
from ..utils.mfu import device_hbm_bandwidth, device_peak_flops, mfu
from ..utils.pytree import tree_leaves, tree_map, tree_replace_leaves
from .checkpoints import load_legacy_checkpoint, save_checkpoint
from .config import TrainConfig, unported_settings
from .logging import MetricsLogger

REWARD_KEYS = ("clip_aesthetic", "clip_text", "no_artifacts", "pickscore", "combined")


def _combine_and_update(theta: Any, prev_delta: Any, noise: Any, rewards: Dict[str, torch.Tensor], *,
                        tc: TrainConfig, es_cfg, pop: int, num_unique: int, repeats: int,
                        lr: Optional[torch.Tensor] = None):
    """Rewards → scores → fitness → EGGROLL update → caps → metrics.
    Returns ``(θ', Δθ, metrics, opt_scores)``. ``lr`` (the fleet's per-job
    f32 ``lr_scale·σ`` as a device tensor) replaces ``es_cfg.lr``."""
    # S[k, j]: mean over repeats (grouped layout [r][m])
    S = rewards["combined"].reshape(pop, repeats, num_unique).mean(dim=1)
    if tc.promptnorm:
        opt_scores, _, sigma_bar = prompt_normalized_scores(S)
    else:
        opt_scores = S.mean(dim=1)
        sigma_bar = torch.zeros((), device=S.device)
    fitness, n_finite = standardize_fitness_masked(opt_scores)
    theta_new = es_update(theta, noise, fitness, pop, es_cfg, lr=lr)
    theta_new, step_scale = cap_step_norm(theta, theta_new, tc.max_step_norm)
    theta_new, theta_scale = cap_theta_norm(theta_new, tc.theta_max_norm)
    delta = tree_replace_leaves(theta, [a - b for a, b in zip(tree_leaves(theta_new), tree_leaves(theta))])
    metrics = {
        "opt_score_mean": opt_scores.mean(),
        "opt_score_best": opt_scores.max(),
        "opt_score_worst": opt_scores.min(),
        "sigma_bar": sigma_bar,
        "n_finite": n_finite,
        "theta_norm": global_norm(theta_new),
        "delta_norm": global_norm(delta),
    }
    metrics.update(es_health_metrics(
        opt_scores=opt_scores, fitness=fitness, delta=delta, prev_delta=prev_delta,
        cap_theta_scale=theta_scale, cap_step_scale=step_scale, pop_size=pop, antithetic=es_cfg.antithetic,
    ))
    for k in REWARD_KEYS:
        if k in rewards:
            metrics[f"reward/{k}_mean"] = rewards[k].mean()
    metrics["per_prompt_mean"] = S.mean(dim=0)
    if tc.quality:
        metrics.update(quality_metrics(rewards, pop=pop, num_unique=num_unique, repeats=repeats,
                                       reward_keys=REWARD_KEYS))
    return theta_new, delta, metrics, opt_scores


def es_draws(backend: Any, theta: Any, key: torch.Tensor, pop: int, es_cfg: Any, count: int,
             noise: Any = None, gen_noise: Optional[torch.Tensor] = None) -> Tuple[Any, torch.Tensor]:
    """An epoch's draws from its key, as the JAX step makes them: ``key``
    splits into (noise key, generation key); the ES noise for ``theta``, and
    the generation noise of images ``range(count)`` (global positions).
    ``noise``/``gen_noise``, where given, stand in for their draw. The step
    calls it from inside its program (tests replace it here)."""
    k_noise, k_gen = threefry.split(key)
    if noise is None:
        noise = sample_noise(k_noise, theta, pop, es_cfg)
    if gen_noise is None:
        gen_noise = backend.sample_gen_noise(k_gen, range(count))
    return noise, gen_noise


def device_ids(flat_ids: Any, dev: torch.device) -> torch.Tensor:
    """Prompt ids as an int64 tensor on ``dev`` (a list crosses once, before
    any program runs)."""
    if isinstance(flat_ids, torch.Tensor):
        return flat_ids.to(device=dev, dtype=torch.long)
    return torch.tensor(list(flat_ids), dtype=torch.long).to(dev)


def program_cache(backend: Any, dev: torch.device, **kw: Any) -> GraphCache:
    """The ES step's program cache on ``dev``: CUDA graphs on the card,
    unless the backend's ``cuda_graphs`` is False, then eager. A backend
    with a ``workspace_bytes`` (Infinity's KV cache, outside the graphs'
    pools) has it reported in each entry's stats."""
    kw.setdefault("workspace", (lambda: backend.workspace_bytes) if hasattr(backend, "workspace_bytes") else None)
    return GraphCache(dev, graph=getattr(backend, "cuda_graphs", True), **kw)


def make_es_step(backend: Any, reward_fn: Any, tc: TrainConfig, num_unique: int, repeats: int,
                 device: DeviceLike = None, *, stateful_delta: bool = False, graphs: Optional[GraphCache] = None):
    """Build the epoch step for a fixed (m prompts, r repeats) plan.

    Returns ``step(theta, flat_ids [m·r], key, noise=None, gen_noise=None)
    → (θ', metrics, opt_scores)``; with ``stateful_delta=True``,
    ``step(theta, prev_delta, flat_ids, key, ...) → (θ', Δθ, metrics,
    opt_scores)``, which feeds ``es/update_cosine``. ``key`` is the epoch's
    ``utils.threefry`` key; it splits into the ES noise key and the
    generation key, and image ``i`` of every member draws from the
    generation key folded with ``i``, its global position. ``metrics`` is the JAX
    package's dict (``quality/*`` with ``tc.quality``), as tensors on the
    device.

    The step is one program of ``graphs`` (a ``utils.graphs.GraphCache``;
    ``None``: a cache of its own, :func:`program_cache`), keyed ``(m, r)``
    as the JAX package keys its AOT step: draws, member evaluation, scores,
    update and caps, from θ, Δθ, the ids and the key, with nothing copied
    from the host inside it. On the card its first call warms up and
    captures a CUDA graph and every later call replays it; the outputs are
    the graph's buffers, overwritten by the next call (pass them back in as
    θ and Δθ, or clone them to keep them). A cache made with
    ``graph=False`` runs it eagerly on the card. ``step.graphs`` is the
    cache.

    ``device`` must be the backend's device; ``None`` means the card and
    raises without one. ``noise`` (a tree from ``es.sample_noise``'s
    structure) and ``gen_noise`` (``[m·r, *backend.noise_shape]``) replace
    the step's own draws (another entry of the cache)."""
    dev = resolve_device(device)
    if dev != backend.device:
        raise ValueError(f"make_es_step on {dev}, but the backend lives on {backend.device}")
    es_cfg = tc.es_config()
    pop = tc.pop_size
    eval_pop = make_population_evaluator(backend.generate_p, reward_fn, pop, es_cfg, tc.member_batch,
                                         reward_tile=tc.reward_tile, pop_fuse=tc.pop_fuse)
    count = num_unique * repeats
    if graphs is None:
        graphs = program_cache(backend, dev)

    def core(theta, prev_delta, ids, key, noise, gen_noise):
        noise, gen_noise = es_draws(backend, theta, key, pop, es_cfg, count, noise=noise, gen_noise=gen_noise)
        rewards = eval_pop(theta, noise, ids, gen_noise.to(torch.float32))
        return _combine_and_update(theta, prev_delta, noise, rewards, tc=tc, es_cfg=es_cfg,
                                   pop=pop, num_unique=num_unique, repeats=repeats)

    def run(theta, prev_delta, flat_ids, key: torch.Tensor, noise=None, gen_noise=None):
        ids = device_ids(flat_ids, dev)
        if ids.numel() != count:
            raise ValueError(f"{ids.numel()} prompt ids for a plan of {num_unique}×{repeats}")
        to_dev = lambda t: t.to(dev)  # noqa: E731
        args = (tree_map(to_dev, theta), tree_map(to_dev, prev_delta), ids, key.to(dev),
                None if noise is None else tree_map(to_dev, noise),
                None if gen_noise is None else gen_noise.to(dev))
        plan = (num_unique, repeats) if noise is None and gen_noise is None else \
            (num_unique, repeats, "draws given")
        return graphs(plan, core, *args)

    run.graphs = graphs
    if stateful_delta:
        return run

    def step(theta, flat_ids, key: torch.Tensor, noise=None, gen_noise=None):
        zeros = tree_map(torch.zeros_like, theta)
        theta_new, _delta, metrics, opt_scores = run(theta, zeros, flat_ids, key, noise, gen_noise)
        return theta_new, metrics, opt_scores

    step.graphs = graphs
    return step


def fleet_scalar_args(tc_list: Sequence[TrainConfig]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-job ``(sigmas [W], c_scales [W], lrs [W])`` as float32 numpy rows,
    each value rounded once from float64: ``f32(σ_j)``, ``f32(σ_j/√r_j)``,
    ``f32(lr_scale_j·σ_j)``. These are the numbers the solo step uses (its
    constants and its Python-float multiplies round the same float64 values
    once), so a fleet job gets its solo bits; computing ``σ/√r`` on the
    device from an f32 σ would round twice."""
    sigmas, c_scales, lrs = [], [], []
    for tcj in tc_list:
        cfg = tcj.es_config()
        sigmas.append(np.float32(cfg.sigma))
        c_scales.append(np.float32(cfg.sigma / math.sqrt(cfg.rank)))
        lrs.append(np.float32(cfg.lr))
    return (np.asarray(sigmas, np.float32), np.asarray(c_scales, np.float32), np.asarray(lrs, np.float32))


def make_fleet_step(backend: Any, reward_fn: Any, tc: TrainConfig, num_unique: int, repeats: int, width: int,
                    device: DeviceLike = None, *, graphs: Optional[GraphCache] = None):
    """Build the step that advances ``width`` independent ES jobs against
    one resident base in one program (port of the JAX ``make_fleet_step``).

    Returns ``fleet_step(stacked_theta, stacked_prev_delta, flat_ids
    [W, m·r], keys [W, 2], sigmas [W], c_scales [W], lrs [W]) → (θ′
    stacked, Δθ stacked, metrics, opt_scores [W, pop])``: θ and Δθ are
    adapter trees whose leaves carry a leading job axis
    (``lora.stack_adapters`` of W solo trees), every metric gains a leading
    job axis, and ``metrics["fleet_reward_rows"]`` is the ``[W, pop, B]``
    combined reward rows. ``sigmas``/``c_scales``/``lrs`` are
    :func:`fleet_scalar_args`' rows on the device.

    Job ``j`` is the solo step with its own hyperparameters: its key splits
    as the solo step's (:func:`es_draws`), its noise is ``sample_noise``
    under its own key, its members run through
    ``parallel.pop_eval.make_fleet_evaluator`` (the solo chunks, σ_j as an
    input), and its update is the solo :func:`_combine_and_update` on its
    slice with ``lr=lrs[j]``, a loop over W inside the program: promptnorm
    and standardization are per job (``es.jobwise_prompt_normalized_scores``),
    never pooled. So job ``j``'s rows, θ′ and Δθ are bitwise the solo step's
    for the same θ, Δθ, ids and key; the loop's W trips of small ops are
    paid once, at the capture.

    ``tc`` is the cohort (``train.fleet.COHORT_FIELDS``); its σ and lr are
    not read. The step is one program of ``graphs`` (``None``: its own
    :func:`program_cache`), keyed ``("fleet", W, m, r)``: the stacked θ and
    Δθ, ids, keys and the three rows are its static inputs, so any job mix
    at a width is an argument change, never a new capture. Outputs are the
    graph's buffers (clone to keep). ``step.graphs`` is the cache;
    ``step.traces`` counts the Python runs of the program body (on the card
    a warm-up and a capture per program, on the CPU every call)."""
    dev = resolve_device(device)
    if dev != backend.device:
        raise ValueError(f"make_fleet_step on {dev}, but the backend lives on {backend.device}")
    W = int(width)
    if W < 1:
        raise ValueError(f"fleet width must be >= 1, got {width}")
    es_cfg = tc.es_config()
    pop = tc.pop_size
    count = num_unique * repeats
    eval_fleet = make_fleet_evaluator(backend.generate_p, reward_fn, W, pop, es_cfg, tc.member_batch,
                                      reward_tile=tc.reward_tile, pop_fuse=tc.pop_fuse)
    if graphs is None:
        graphs = program_cache(backend, dev)

    def core(stacked_theta, stacked_prev, ids, keys, sigmas, c_scales, lrs):
        run.traces += 1
        thetas = [lane_slice(stacked_theta, j) for j in range(W)]
        draws = [es_draws(backend, thetas[j], keys[j], pop, es_cfg, count) for j in range(W)]
        noises = [d[0] for d in draws]
        gen_noise = torch.stack([d[1] for d in draws]).to(torch.float32)
        rewards = eval_fleet(thetas, noises, ids, gen_noise, sigmas, c_scales)
        outs = [_combine_and_update(thetas[j], lane_slice(stacked_prev, j), noises[j],
                                    {k: v[j] for k, v in rewards.items()}, tc=tc, es_cfg=es_cfg, pop=pop,
                                    num_unique=num_unique, repeats=repeats, lr=lrs[j])
                for j in range(W)]
        theta_new = stack_adapters([o[0] for o in outs])
        delta = stack_adapters([o[1] for o in outs])
        metrics = {k: torch.stack([o[2][k] for o in outs]) for k in outs[0][2]}
        metrics["fleet_reward_rows"] = rewards["combined"]
        return theta_new, delta, metrics, torch.stack([o[3] for o in outs])

    def run(stacked_theta, stacked_prev_delta, flat_ids, keys, sigmas, c_scales, lrs):
        ids = device_ids(flat_ids, dev).reshape(W, -1)
        if ids.shape[1] != count:
            raise ValueError(f"{ids.shape[1]} prompt ids a job for a plan of {num_unique}×{repeats}")
        rows = [torch.as_tensor(x, dtype=torch.float32).to(dev) for x in (sigmas, c_scales, lrs)]
        if any(tuple(r.shape) != (W,) for r in rows) or tuple(keys.shape) != (W, 2):
            raise ValueError(f"a fleet of {W} takes keys [W, 2] and σ/c/lr rows [W]")
        to_dev = lambda t: t.to(dev)  # noqa: E731
        return graphs(("fleet", W, num_unique, repeats), core, tree_map(to_dev, stacked_theta),
                      tree_map(to_dev, stacked_prev_delta), ids, keys.to(dev), *rows)

    run.graphs = graphs
    run.traces = 0
    return run


@dataclasses.dataclass
class TrainState:
    theta: Any
    epoch: int = 0
    preempted: bool = False  # SIGTERM/SIGINT honored: slot saved, preempted.json written
    halted: bool = False  # the rollback policy gave up: halted.json says why
    rollbacks: int = 0


# spans whose durations feed phase_<name>_seconds histograms
_PHASES = frozenset(("compile", "dispatch", "plan", "log", "checkpoint", "hist", "strip", "snapshot"))


def _init_theta(backend: Any, tc: TrainConfig, dev: torch.device) -> Any:
    """θ₀, drawn from ``fold_in(PRNGKey(seed), 17)`` on ``dev`` as in the
    JAX package."""
    return backend.init_theta(threefry.fold_in(threefry.prng_key(tc.seed, dev), 17))


def run_training(backend: Any, reward_fn: Any, tc: TrainConfig,
                 on_epoch_end: Optional[Callable[[int, Dict[str, Any]], None]] = None,
                 device: DeviceLike = None) -> TrainState:
    """Train ``tc.num_epochs`` epochs of ES on one device (``None``: the
    card) into ``tc.run_dir / tc.auto_run_name(backend.name)``.

    Per dispatch: the plan (``backend.step_info(epoch, …)``), the step (one
    program per (m, r)), run once, or ``K = min(steps_per_dispatch, epochs
    left, epochs until the next due one)`` times with one read-back once the
    plan has run (the chain's ids and keys staged on the device first; the
    row is its last epoch's, with ``epochs_chained = K``, ``step_time_s`` the
    dispatch's time over K), the scalars (the step's metrics plus ``epoch``,
    ``incarnation``, ``epochs_chained``, ``step_time_s``,
    ``images_scored``, ``images_per_sec``, ``prompts``), the degeneracy
    watchdog, the quality ledger, the ``metrics.jsonl`` row with the
    ``obs/`` and ``resilience/`` counters, the non-finite guard (restore
    the last slot, then ``tc.rollback_policy``; ``halted.json`` when it
    gives up), a slot every ``save_every`` epochs and at the last one,
    ``on_epoch_end(epoch, scalars)``, and a checkpoint plus
    ``preempted.json`` at the boundary after SIGTERM/SIGINT. With
    ``tc.resume`` the newest valid slot (θ, Δθ, the spent rollbacks and a
    shrunk σ), else the legacy mirror, sets the starting point.

    Artifacts, as the JAX loop makes them: a plan's first dispatch writes
    its ``programs.jsonl`` record (site ``train``, label
    ``es_step_m{m}r{r}``; FLOPs and bytes counted over the warm-up epoch,
    ``utils.graphs.GraphCache(count_cost=True)``); each row carries ``mfu``
    and ``roofline/*`` from that record and the dispatch's time per epoch
    where the card's peaks are known. At an unchained epoch due for it, θ
    is copied before the dispatch (the step's outputs are the graph's
    buffers, overwritten by the next replay) and the row gains
    ``hist/theta``, ``hist/delta_theta`` and ``hist/pop_scores``
    (``tc.log_hist_every``); ``epoch_XXXX/`` gets the best, median and
    worst members' strips (``tc.log_images_every``) and ``snapshots/``
    the best member's grid (``tc.snapshot_every``; a failure is counted
    under ``cleanup_errors`` and warned about). ``tc.profile_epochs``
    runs ``torch.profiler`` from the first epoch for that many epochs,
    unchained, each dispatch inside a ``train/<label>`` range; at its end
    the trace goes to ``profile/train.pt.trace.json`` and
    ``obs.calib.calibrate_run`` writes ``CALIB_train.json`` and the
    ``calib/*`` gauges. A profiler that does not start raises. At the end
    (``tc.quality``) ``QUALITY_train.json`` is written, best-effort.

    Telemetry, as the JAX loop wires it: each logged dispatch ticks the SLO
    evaluator (``tc.slo``, ``obs.slo.build_trainer_evaluator``) and the
    anomaly watchdog (``tc.anomaly_detect``: ``anomalies.jsonl`` and
    ``anomaly/*``), both merged into the row, then publishes the row's
    numbers to the exporter by reference swap. ``tc.metrics_port`` serves
    ``/metrics`` (the run's registries, the SLO and anomaly registries and
    the last row's scalars) and ``/healthz`` with the JAX keys
    (``backend``, ``run_dir``, ``topology``, ``membership``,
    ``resilience``, ``queue: None``, ``sentry_verdict`` when the run dir
    holds one): ``membership`` and ``resilience`` carry the one-process
    values (one incarnation, rank 0 live, no transitions; this run's
    ``resilience/*`` counters), the pod's views being ROADMAP items 7 and
    10. ``tc.heartbeat_interval_s`` wraps the compile (a plan's first
    dispatch: warm-up and capture), each later dispatch and each checkpoint
    in a heartbeat; a heartbeat reads only the allocator's counters, never
    a CUDA call that could break a capture. ``tc.stall_cap_s`` arms the
    stall watchdog: ``stall_action="checkpoint_exit"`` requests a
    preemption, so the run saves at the next boundary and ends as
    preempted."""
    unported = unported_settings(tc)
    if unported:
        raise NotImplementedError("the port's run_training does not have this machinery yet: "
                                  + "; ".join(unported))
    dev = resolve_device(device)
    backend.setup()
    run_dir = Path(tc.run_dir) / tc.auto_run_name(backend.name)
    registry = MetricsRegistry()
    res_registry = MetricsRegistry(prefix="resilience/")
    logger = MetricsLogger(run_dir, registry=res_registry)

    def observe_phase(name: str, dur_s: float) -> None:
        if name in _PHASES:
            registry.observe(f"phase_{name}_seconds", dur_s)

    tracer = Tracer(run_dir / "trace.jsonl" if tc.trace else None, on_span=observe_phase)
    # the launch topology every slot records and a resume must match
    topology = {"process_count": 1, "pop_shards": 1, "pop_size": tc.pop_size, "pop_host_shard": False}
    store = CheckpointStore(run_dir, keep=tc.ckpt_keep, registry=res_registry)
    rollback_ctrl = RollbackController(policy=tc.rollback_policy, max_rollbacks=tc.max_rollbacks,
                                       sigma_shrink=tc.rollback_sigma_shrink, explode_norm=tc.theta_explode_norm)
    for stale in (PREEMPT_MARKER, HALT_MARKER):  # this run is live now
        (run_dir / stale).unlink(missing_ok=True)
    quality_ledger = (QualityLedger(run_dir, reward_keys=REWARD_KEYS, hack_window=tc.quality_hack_window)
                      if tc.quality else None)

    def degenerate(consecutive: int) -> None:
        registry.inc("es_degenerate_warnings")
        emit_heartbeat("train", "es_degenerate", consecutive=consecutive)
        print(f"[obs] WATCHDOG: fitness degenerate for {consecutive} consecutive logged generations — the ES "
              "update is a no-op (constant or all-NaN rewards; see es/fitness_zero and es/reward_std in "
              "metrics.jsonl)", file=sys.stderr, flush=True)

    degen_watchdog = DegeneracyWatchdog(tc.es_degenerate_warn_epochs, degenerate)
    to_dev = lambda t: t.to(dev)  # noqa: E731
    tc_live = tc  # σ shrinks here after a sigma_shrink rollback
    preempt = PreemptionHandler(registry=res_registry).install()

    # ---- live telemetry ----------------------------------------------------
    reset_health()
    # the last row's numbers, published to the exporter's thread by swapping
    # the dict in this holder (never mutated while a scrape may iterate it)
    latest_scalars_ref: Dict[str, Dict[str, Any]] = {"scalars": {}}
    slo_eval = build_trainer_evaluator(tc.slo, registry, res_registry) if tc.slo else None
    anomaly_watchdog = (AnomalyWatchdog(run_dir=run_dir, window=tc.anomaly_window,
                                        min_history=tc.anomaly_min_epochs, z_thresh=tc.anomaly_z)
                        if tc.anomaly_detect else None)
    incarnation = {"id": "pending"}

    def healthz() -> Dict[str, Any]:
        payload: Dict[str, Any] = {
            "backend": backend.name,
            "run_dir": str(run_dir),
            "topology": topology,
            "membership": {"incarnation": incarnation["id"], "live_ranks": [0], "transitions": []},
            "resilience": host_snapshot_payload(registry=res_registry),
            "queue": None,  # the trainer has no serving queue; the key is shared
        }
        verdict = run_dir / "sentry_verdict.json"
        try:
            if verdict.exists():
                vdoc = json.loads(verdict.read_text())
                payload["sentry_verdict"] = {"path": str(verdict), "pass": bool(vdoc.get("pass")),
                                             "breaches": len(vdoc.get("breaches") or []),
                                             "checked": vdoc.get("checked")}
        except Exception as e:
            payload["sentry_verdict"] = {"error": repr(e)}
        return payload

    def stall_warn(name: str, phase: str, elapsed: float) -> None:
        registry.inc("stalls")
        print(f"[obs] WATCHDOG: {name}/{phase} still running after {elapsed:.0f}s (stall cap "
              f"{tc.stall_cap_s:.0f}s)", file=sys.stderr, flush=True)
        if tc.stall_action == "checkpoint_exit":
            # on the heartbeat thread: request() only latches a flag, the
            # loop saves at the next boundary and ends as preempted
            preempt.request(f"stall escalation: {name}/{phase} exceeded {tc.stall_cap_s:.0f}s "
                            "(stall_action checkpoint_exit)")

    def hb(phase: str, gauges: Any = lambda: device_memory_gauges(dev)):
        return maybe_heartbeat("train", phase, interval_s=tc.heartbeat_interval_s, stall_cap_s=tc.stall_cap_s,
                               on_stall=stall_warn, stall_payload={"stall_action": tc.stall_action},
                               gauges=gauges)

    exporter = None
    profiler = None  # the open profile window, stopped in `finally` if the run ends inside it
    try:
        exporter = maybe_exporter(
            tc.metrics_port, host=tc.metrics_host,
            registries=[registry, res_registry] + ([slo_eval.registry] if slo_eval is not None else [])
            + ([anomaly_watchdog.registry] if anomaly_watchdog is not None else []),
            scalar_sources=[lambda: latest_scalars_ref["scalars"]],
            healthz_source=healthz,
        )
        if exporter is not None:
            logger.info(f"live telemetry: /metrics + /healthz on port {exporter.port}")
        with tracer.span("setup"):
            theta = _init_theta(backend, tc, dev)
            start_epoch, restored_delta = 0, None
            if tc.resume:
                res = store.restore(theta, with_delta=True, expect_topology=topology)
                if res is not None:
                    theta, start_epoch, restored_delta = res.theta, res.epoch, res.prev_delta
                    logger.info(f"resumed from epoch {start_epoch} (slot {res.slot})")
                    # a σ shrunk by rollbacks survives a restart, with the rollbacks spent
                    slot_cfg = (res.meta or {}).get("config") or {}
                    rollback_ctrl.rollbacks = int(slot_cfg.get("_rollbacks", 0) or 0)
                    slot_sigma = slot_cfg.get("sigma")
                    if rollback_ctrl.rollbacks > 0 and slot_sigma is not None and float(slot_sigma) != tc.sigma:
                        tc_live = dataclasses.replace(tc, sigma=float(slot_sigma))
                        logger.info(f"resuming with effective sigma={tc_live.sigma:g} from the checkpoint "
                                    f"(config sigma={tc.sigma:g} was shrunk by {rollback_ctrl.rollbacks} "
                                    "rollback(s))")
                else:
                    legacy = load_legacy_checkpoint(run_dir, theta, registry=res_registry)
                    if legacy is not None:
                        theta, start_epoch = legacy
                        logger.info(f"resumed from epoch {start_epoch} (legacy checkpoint)")
            # θ and Δθ_{t−1} live on the device from here on; a restored
            # slot crosses once
            theta = tree_map(to_dev, theta)
            prev_delta = (tree_map(to_dev, restored_delta) if restored_delta is not None
                          else tree_map(torch.zeros_like, theta))

        incarnation["id"] = f"i{start_epoch}.n1"
        set_ledger(ProgramLedger(run_dir / "programs.jsonl"))
        state = TrainState(theta=theta, epoch=start_epoch, rollbacks=rollback_ctrl.rollbacks)
        step_cache: Dict[Tuple[int, int], Callable] = {}
        # one program per (m, r) plan: a CUDA graph on the card, its warm-up counted
        programs = program_cache(backend, dev, registry=registry, tracer=tracer, count_cost=True,
                                 span_attrs=lambda plan: {"m": plan[0], "r": plan[1]})
        # each plan's ledger record (the MFU and roofline inputs), and the
        # host's wall seconds of its latest dispatch (the calibration's
        # fallback where the profile has no device time)
        step_cost: Dict[Tuple[int, int], Dict[str, Any]] = {}
        host_step_s: Dict[str, float] = {}
        peak_flops, hbm_bw = device_peak_flops(dev), device_hbm_bandwidth(dev)
        if tc.profile_epochs > 0:
            profiler = start_profile(dev)
            logger.info(f"profiler trace on for {tc.profile_epochs} epochs → {run_dir / 'profile'}")
        last_saved_boundary = -1

        def do_save(boundary: int, reward: float) -> None:
            """One slot at an epoch boundary, once (a preemption on a
            save_every boundary writes one)."""
            nonlocal last_saved_boundary
            if last_saved_boundary == boundary:
                return
            with tracer.span("checkpoint"), hb("checkpoint"):
                save_checkpoint(run_dir, state.theta, boundary, reward, backend.name,
                                config={**dataclasses.asdict(tc_live), "_rollbacks": rollback_ctrl.rollbacks},
                                prev_delta=prev_delta, keep=tc.ckpt_keep, legacy_mirror=tc.ckpt_legacy_mirror,
                                topology=topology, registry=res_registry)
            last_saved_boundary = boundary
            res_registry.gauge("last_saved_epoch", boundary)

        def _epochs_until_due(e: int) -> int:
            """Epochs from ``e`` to the next one with host work of its own
            (θ histograms, strips, a checkpoint, a snapshot): 0 means ``e``
            itself is due. A chain does not cross one (the JAX loop's rule)."""
            d = None
            for every in (tc.log_hist_every, tc.log_images_every, tc.save_every, tc.snapshot_every):
                if every:
                    rr = (every - (e + 1) % every) % every
                    d = rr if d is None else min(d, rr)
            return 10**9 if d is None else d

        epoch = start_epoch
        while epoch < tc.num_epochs:
            with tracer.span("epoch", epoch=epoch):
                t0 = time.perf_counter()
                with tracer.span("plan"):
                    info = backend.step_info(epoch, tc.prompts_per_gen, tc.batches_per_gen)
                    m, r = len(info.unique_ids), info.repeats
                warm = (m, r) in step_cache
                if not warm:
                    step_cache[(m, r)] = make_es_step(backend, reward_fn, tc_live, m, r, dev, stateful_delta=True,
                                                      graphs=programs)
                # epochs per dispatch: K > 1 only once the plan has run,
                # outside the profile window, and with nothing due inside
                # the chain (the JAX loop's rule)
                K = 1
                in_window = profiler is not None and epoch - start_epoch < tc.profile_epochs
                if tc.steps_per_dispatch > 1 and warm and not in_window and _epochs_until_due(epoch) > 0:
                    K = min(tc.steps_per_dispatch, tc.num_epochs - epoch, _epochs_until_due(epoch))
                infos = [info]
                if K > 1:
                    infos += [backend.step_info(e, tc.prompts_per_gen, tc.batches_per_gen)
                              for e in range(epoch + 1, epoch + K)]
                    if any((len(i.unique_ids), i.repeats) != (m, r) for i in infos):
                        K, infos = 1, [info]  # the geometry changed mid-chain
                # the chain's ids and keys, staged on the device before any replay
                ids_k = device_ids([f for i in infos for f in i.flat_ids], dev).reshape(K, m * r)
                keys_k = torch.stack([epoch_key(tc.seed, epoch + j, dev) for j in range(K)])
                due = [bool(every) and K == 1 and (epoch + 1) % every == 0
                       for every in (tc.log_hist_every, tc.log_images_every, tc.snapshot_every)]
                hist_due, strips_due, snapshot_due = due
                # θ before the update, for Δθ and the member regenerations:
                # a copy, since the step's outputs are the graph's buffers
                theta_before = tree_map(torch.clone, state.theta) if any(due) else None
                label = f"es_step_m{m}r{r}"
                # a plan's first dispatch is its compile (warm-up and
                # capture); no device gauges inside a timed dispatch
                with tracer.span("dispatch", epochs=K), (hb("dispatch", gauges=None) if warm else hb("compile")), \
                        (torch.profiler.record_function(f"train/{label}") if in_window else contextlib.nullcontext()):
                    # θ and Δθ carry through the program's buffers; one
                    # read-back at the chain's end
                    for j in range(K):
                        state.theta, prev_delta, metrics, opt_scores = step_cache[(m, r)](
                            state.theta, prev_delta, ids_k[j], keys_k[j])
                    scalars: Dict[str, Any] = {k: (v.tolist() if v.ndim else float(v)) for k, v in metrics.items()}
                info = infos[-1]  # a chain logs its last epoch's prompts
                dt = time.perf_counter() - t0
                opt_np = opt_scores.float().cpu().numpy() if theta_before is not None else None
                if not warm:
                    entry = programs.entries[(m, r)]
                    step_cost[(m, r)] = record_program(
                        site="train", label=label, stats=entry.stats, cost=entry.cost, device=dev,
                        geometry={"m": m, "r": r, "pop": tc.pop_size, "member_batch": tc.member_batch,
                                  "remat": tc_live.remat, "noise_dtype": tc_live.noise_dtype,
                                  "tower_dtype": tc_live.tower_dtype, "pop_fuse": tc_live.pop_fuse,
                                  "base_quant": tc_live.base_quant, "mesh_shape": None, "n_devices": 1})
                prog = step_cost.get((m, r), {})
                if K == 1:
                    host_step_s[f"train/{label}"] = dt
                epoch = epoch + K - 1  # the chain's last epoch from here on
                registry.inc("dispatches")
                registry.inc("epochs_dispatched", K)
                registry.observe("train_step_time_seconds", dt / K)
                record_device_memory(registry, dev)
                n_images = tc.pop_size * m * r * K
                scalars.update(epoch=epoch, incarnation=int(start_epoch), epochs_chained=K, step_time_s=dt / K,
                               images_scored=n_images, images_per_sec=n_images / max(dt, 1e-9), prompts=info.texts)
                u = mfu(prog.get("flops"), dt / K, device=dev)
                if u is not None:
                    scalars["mfu"] = u
                # which resource binds the step (obs.program_cost.roofline);
                # absent where the peaks are unknown (the CPU)
                rf = roofline(prog.get("flops"), prog.get("bytes_accessed"), dt / K, peak_flops=peak_flops,
                              hbm_bw=hbm_bw)
                if rf["bound"] is not None:
                    scalars["roofline/bound"] = rf["bound"]
                    scalars["roofline/intensity"] = rf["intensity"]
                    for rk in ("t_compute_s", "t_bandwidth_s", "t_roofline_s"):
                        if rf[rk] is not None:
                            scalars[f"roofline/{rk}"] = rf[rk]
                degen_watchdog.update(float(scalars.get("es/fitness_zero", 0.0)) >= 0.5)
                rollback_action = None
                if rollback_ctrl.is_bad(scalars.get("theta_norm")):
                    rollback_action = rollback_ctrl.next_action()
                    state.rollbacks = rollback_ctrl.rollbacks
                    res_registry.inc("rollbacks")
                    print(f"[resilience] WATCHDOG: non-finite/diverged theta at epoch {epoch} "
                          f"(theta_norm={scalars.get('theta_norm')}) — rollback #{rollback_ctrl.rollbacks}, "
                          f"action={rollback_action}", file=sys.stderr, flush=True)
                if hist_due and rollback_action is None:
                    with tracer.span("hist"):
                        scalars.update(_histograms(theta_before, state.theta, opt_np))
                if slo_eval is not None:
                    slo_eval.tick()
                    scalars.update(slo_eval.registry.snapshot())
                if anomaly_watchdog is not None:
                    anomaly_watchdog.observe(epoch, scalars)
                    scalars.update(anomaly_watchdog.registry.snapshot())
                if quality_ledger is not None:
                    scalars.update(quality_ledger.observe(epoch, scalars))
                scalars.update(registry.snapshot())
                scalars.update(res_registry.snapshot())
                with tracer.span("log"):
                    logger.log(epoch, scalars)
                latest_scalars_ref["scalars"] = {
                    k: v for k, v in scalars.items()
                    if isinstance(v, (int, float)) and not k.startswith(("obs/", "resilience/", "slo/", "anomaly/"))
                }
                note_health(last_completed_epoch=int(epoch))

                if rollback_action is not None:
                    restored = None
                    if rollback_action != "halt":
                        restored = store.restore(state.theta, with_delta=True, expect_topology=topology)
                        if restored is None:
                            logger.info("rollback requested but no valid checkpoint slot — halting")
                            rollback_action = "halt"
                    if rollback_action == "halt":
                        write_marker(run_dir, HALT_MARKER, {
                            "epoch": int(epoch), "reason": "non-finite theta", "rollbacks": rollback_ctrl.rollbacks,
                            "theta_norm": str(scalars.get("theta_norm")), "policy": rollback_ctrl.policy,
                        })
                        state.halted = True
                        logger.info(f"HALT (non-finite theta) after {rollback_ctrl.rollbacks} rollback(s) at "
                                    f"epoch {epoch} — see {HALT_MARKER}")
                        break
                    state.theta = tree_map(to_dev, restored.theta)
                    prev_delta = (tree_map(to_dev, restored.prev_delta) if restored.prev_delta is not None
                                  else tree_map(torch.zeros_like, state.theta))
                    last_saved_boundary = -1
                    res_registry.gauge("last_good_epoch", restored.epoch)
                    if rollback_action == "sigma_shrink":
                        tc_live = dataclasses.replace(tc_live, sigma=tc_live.sigma * rollback_ctrl.sigma_shrink)
                        step_cache.clear()
                        programs.clear()
                        epoch = restored.epoch
                        logger.info(f"rollback → slot {restored.slot}: replaying from epoch {epoch} with "
                                    f"sigma={tc_live.sigma:g}")
                    else:  # skip: keep the restored θ, fresh draws past the bad epoch
                        logger.info(f"rollback → slot {restored.slot}: skipping past epoch {epoch}")
                        epoch += 1
                    state.epoch = epoch
                    continue

                if strips_due:
                    with tracer.span("strip"):
                        _save_member_strips(backend, theta_before, tc_live, epoch, info, opt_np, run_dir)
                if snapshot_due:
                    # the best member's decoded grid; best-effort: a decode or
                    # PNG failure never ends the run
                    with tracer.span("snapshot"):
                        try:
                            _save_quality_snapshot(backend, theta_before, tc_live, epoch, info, opt_np, run_dir)
                        except Exception as e:
                            registry.inc("cleanup_errors")
                            print(f"[quality] WARNING: snapshot failed ({type(e).__name__}: {e})",
                                  file=sys.stderr, flush=True)
                theta_before = None
                if profiler is not None and epoch + 1 - start_epoch >= tc.profile_epochs:
                    prof, profiler = profiler, None
                    stop_profile(prof, run_dir / "profile" / "train.pt.trace.json")
                    _calibrate(run_dir, host_step_s, registry, logger)
                if tc.save_every and ((epoch + 1) % tc.save_every == 0 or epoch + 1 == tc.num_epochs):
                    do_save(epoch + 1, scalars["opt_score_mean"])
                res_registry.gauge("last_good_epoch", epoch + 1)
                if on_epoch_end is not None:
                    on_epoch_end(epoch, scalars)
                epoch += 1
                state.epoch = epoch
                if preempt.requested:
                    do_save(epoch, scalars["opt_score_mean"])
                    write_marker(run_dir, PREEMPT_MARKER, {"epoch": int(epoch), "reason": preempt.reason})
                    res_registry.gauge("preempted", 1)
                    state.preempted = True
                    logger.info(f"preempted at epoch boundary {epoch} — checkpoint saved; resume with --resume auto")
                    break
        return state
    finally:
        if profiler is not None:
            try:
                stop_profile(profiler, run_dir / "profile" / "train.pt.trace.json")
            except Exception as e:  # never masks the run's own failure, never silent
                registry.inc("cleanup_errors")
                print(f"[obs] WARNING: cleanup swallowed {e!r} from the profiler's stop", file=sys.stderr, flush=True)
        if tc.quality:
            _write_quality(run_dir, registry, logger)
        set_ledger(None)
        if exporter is not None:
            if tc.metrics_linger_s > 0:
                emit_heartbeat("train", "metrics_linger", linger_s=tc.metrics_linger_s)
                time.sleep(tc.metrics_linger_s)
            exporter.stop()
        preempt.uninstall()


def _calibrate(run_dir: Path, host_step_s: Dict[str, float], registry: MetricsRegistry,
               logger: MetricsLogger) -> None:
    """The profile window's measured-against-predicted rows →
    ``CALIB_train.json`` and the ``calib/*`` gauges; best-effort."""
    from ..obs import calib

    try:
        payload = calib.calibrate_run(run_dir, host_measured=host_step_s, registry=registry)
        if payload["rows"]:
            calib.write_calib(payload, run_dir / "CALIB_train.json")
            logger.info(f"calibration: {payload['headline']['rows']} row(s), "
                        f"{payload['headline']['device_rows']} with device time → CALIB_train.json")
    except Exception as e:
        registry.inc("cleanup_errors")
        print(f"[obs] WARNING: calibration failed ({type(e).__name__}: {e})", file=sys.stderr, flush=True)


def _write_quality(run_dir: Path, registry: MetricsRegistry, logger: MetricsLogger) -> None:
    """The run's ``QUALITY_train.json`` (``obs.quality``); best-effort."""
    from ..obs.quality import build_quality_artifact, write_quality

    try:
        payload = build_quality_artifact(run_dir)
        if payload["curve"]:
            write_quality(payload, run_dir / "QUALITY_train.json")
            logger.info(f"quality: {payload['epochs']} epoch(s), final reward {payload.get('final_reward'):.6g}, "
                        f"{payload['images_total']:.0f} images ({payload['device_s_source']} device-seconds) → "
                        "QUALITY_train.json")
    except Exception as e:
        registry.inc("cleanup_errors")
        print(f"[quality] WARNING: artifact build failed ({type(e).__name__}: {e})", file=sys.stderr, flush=True)


def _subsample_flat(theta: Any, limit: int = 50_000) -> np.ndarray:
    """θ's values flattened on the host (leaves in the JAX package's order,
    as f32), evenly subsampled to ``limit``."""
    leaves = [t.detach().to("cpu", torch.float32).numpy().ravel() for t in tree_leaves(theta)]
    flat = np.concatenate(leaves) if leaves else np.zeros((0,), np.float32)
    if flat.size > limit:
        idx = np.linspace(0, flat.size - 1, limit).astype(np.int64)
        flat = flat[idx]
    return flat


def _hist_payload(values: np.ndarray, bins: int = 64) -> Dict[str, Any]:
    counts, edges = np.histogram(values, bins=bins)
    return {"counts": counts.tolist(), "edges": edges.tolist()}


def _histograms(theta_before: Any, theta_after: Any, opt_scores: np.ndarray) -> Dict[str, Any]:
    """θ and Δθ value distributions and the population's raw scores, as
    JSONL payloads."""
    t0 = _subsample_flat(theta_before)
    t1 = _subsample_flat(theta_after)
    return {
        "hist/theta": _hist_payload(t1),
        "hist/delta_theta": _hist_payload(t1 - t0),
        "hist/pop_scores": opt_scores.tolist(),
    }


def regenerate_member_images(backend: Any, theta: Any, tc: TrainConfig, epoch: int, member: int,
                             info: Any) -> np.ndarray:
    """Member ``member``'s images of ``epoch``, ``[b, H, W, 3]`` f32 on the
    host, regenerated on the backend's device: the member's perturbation
    and the generation key follow from (seed, epoch, member), as the step
    draws them (``epoch_key`` → split → ``sample_noise`` →
    ``perturb_member`` → ``backend.generate``), so nothing of the
    population is kept between epochs."""
    dev = backend.device
    es_cfg = tc.es_config()
    with torch.inference_mode():
        k_noise, k_gen = threefry.split(epoch_key(tc.seed, epoch, dev))
        theta = tree_map(lambda t: t.to(dev), theta)
        noise = sample_noise(k_noise, theta, tc.pop_size, es_cfg)
        theta_k = perturb_member(theta, noise, member, tc.pop_size, es_cfg)
        images = backend.generate(theta_k, list(info.flat_ids), k_gen)
    return images.to(torch.float32).cpu().numpy()


def _save_member_strips(backend: Any, theta_before: Any, tc: TrainConfig, epoch: int, info: Any,
                        opt_scores: np.ndarray, run_dir: Path) -> None:
    """The best, median and worst members' per-prompt strips under
    ``epoch_XXXX/``, each member regenerated (:func:`regenerate_member_images`)."""
    finite = np.where(np.isfinite(opt_scores))[0]
    if finite.size == 0:
        return
    order = finite[np.argsort(opt_scores[finite])]
    members = {"worst": int(order[0]), "median": int(order[len(order) // 2]), "best": int(order[-1])}
    out_dir = run_dir / f"epoch_{epoch:04d}"
    for name, member in members.items():
        imgs = regenerate_member_images(backend, theta_before, tc, epoch, member, info)
        strip = make_prompt_strip(list(imgs), len(info.texts))
        if strip is not None:
            write_png(out_dir / f"{name}_member{member}_score{opt_scores[member]:.4f}.png", strip)


def _save_quality_snapshot(backend: Any, theta_before: Any, tc: TrainConfig, epoch: int, info: Any,
                           opt_scores: np.ndarray, run_dir: Path) -> Optional[Path]:
    """The best member's whole batch as one grid under ``snapshots/``: a
    row per repeat, a column per unique prompt, 256-pixel tiles (the
    grouped layout ``[repeat][prompt]``)."""
    finite = np.where(np.isfinite(opt_scores))[0]
    if finite.size == 0:
        return None
    best = int(finite[np.argmax(opt_scores[finite])])
    imgs = regenerate_member_images(backend, theta_before, tc, epoch, best, info)
    m = len(info.texts)
    if m <= 0 or len(imgs) == 0:
        return None
    rows = max(1, len(imgs) // m)
    tile = 256
    grid = np.zeros((tile * rows, tile * m, 3), np.uint8)
    for r_i in range(rows):
        for p_i in range(m):
            j = r_i * m + p_i
            if j < len(imgs):
                grid[r_i * tile:(r_i + 1) * tile, p_i * tile:(p_i + 1) * tile] = \
                    resize_lanczos(to_uint8(imgs[j]), (tile, tile))
    return write_png(run_dir / "snapshots" / f"epoch_{epoch:05d}_member{best}_score{opt_scores[best]:.4f}.png", grid)
