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
test can put the JAX package's draws in their place. The pod machinery of
the JAX loop (host-sharded programs, coordinated commit, elastic
membership, the desync check, exporter, SLOs, anomaly watchdog, heartbeats,
fault injection, the XLA ledger, histograms, strips and snapshots) is not
here; ``train.config.unported_settings`` names the ROADMAP item of each.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..es.caps import cap_step_norm, cap_theta_norm, global_norm
from ..es.noiser import es_update, sample_noise
from ..es.sampling import epoch_key
from ..es.scoring import prompt_normalized_scores, standardize_fitness_masked
from ..obs.es_health import DegeneracyWatchdog, es_health_metrics
from ..obs.metrics import MetricsRegistry, record_device_memory
from ..obs.quality import QualityLedger, quality_metrics
from ..obs.trace import Tracer
from ..parallel.pop_eval import make_population_evaluator
from ..resilience.checkpoints import CheckpointStore
from ..resilience.preempt import HALT_MARKER, PREEMPT_MARKER, PreemptionHandler, write_marker
from ..resilience.rollback import RollbackController
from ..utils import threefry
from ..utils.graphs import GraphCache
from ..utils.pytree import tree_leaves, tree_map, tree_replace_leaves
from .checkpoints import load_legacy_checkpoint, save_checkpoint
from .config import TrainConfig, unported_settings
from .logging import MetricsLogger

REWARD_KEYS = ("clip_aesthetic", "clip_text", "no_artifacts", "pickscore", "combined")


def _combine_and_update(theta: Any, prev_delta: Any, noise: Any, rewards: Dict[str, torch.Tensor], *,
                        tc: TrainConfig, es_cfg, pop: int, num_unique: int, repeats: int):
    """Rewards → scores → fitness → EGGROLL update → caps → metrics.
    Returns ``(θ', Δθ, metrics, opt_scores)``."""
    # S[k, j]: mean over repeats (grouped layout [r][m])
    S = rewards["combined"].reshape(pop, repeats, num_unique).mean(dim=1)
    if tc.promptnorm:
        opt_scores, _, sigma_bar = prompt_normalized_scores(S)
    else:
        opt_scores = S.mean(dim=1)
        sigma_bar = torch.zeros((), device=S.device)
    fitness, n_finite = standardize_fitness_masked(opt_scores)
    theta_new = es_update(theta, noise, fitness, pop, es_cfg)
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
    unless the backend's ``cuda_graphs`` is False (Infinity: its KV cache
    would need a second home in a graph's pool), then eager."""
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


@dataclasses.dataclass
class TrainState:
    theta: Any
    epoch: int = 0
    preempted: bool = False  # SIGTERM/SIGINT honored: slot saved, preempted.json written
    halted: bool = False  # the rollback policy gave up: halted.json says why
    rollbacks: int = 0


# spans whose durations feed phase_<name>_seconds histograms
_PHASES = frozenset(("compile", "dispatch", "plan", "log", "checkpoint"))


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
    shrunk σ), else the legacy mirror, sets the starting point."""
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
        print(f"[obs] WATCHDOG: fitness degenerate for {consecutive} consecutive logged generations — the ES "
              "update is a no-op (constant or all-NaN rewards; see es/fitness_zero and es/reward_std in "
              "metrics.jsonl)", file=sys.stderr, flush=True)

    degen_watchdog = DegeneracyWatchdog(tc.es_degenerate_warn_epochs, degenerate)
    to_dev = lambda t: t.to(dev)  # noqa: E731
    tc_live = tc  # σ shrinks here after a sigma_shrink rollback
    preempt = PreemptionHandler(registry=res_registry).install()
    try:
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

        state = TrainState(theta=theta, epoch=start_epoch, rollbacks=rollback_ctrl.rollbacks)
        step_cache: Dict[Tuple[int, int], Callable] = {}
        # one program per (m, r) plan: a CUDA graph on the card
        programs = program_cache(backend, dev, registry=registry, tracer=tracer,
                                 span_attrs=lambda plan: {"m": plan[0], "r": plan[1]})
        last_saved_boundary = -1

        def do_save(boundary: int, reward: float) -> None:
            """One slot at an epoch boundary, once (a preemption on a
            save_every boundary writes one)."""
            nonlocal last_saved_boundary
            if last_saved_boundary == boundary:
                return
            with tracer.span("checkpoint"):
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
                # epochs per dispatch: K > 1 only once the plan has run and
                # nothing is due inside the chain (the JAX loop's rule)
                K = 1
                if tc.steps_per_dispatch > 1 and warm and _epochs_until_due(epoch) > 0:
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
                with tracer.span("dispatch", epochs=K):
                    # θ and Δθ carry through the program's buffers; one
                    # read-back at the chain's end
                    for j in range(K):
                        state.theta, prev_delta, metrics, _ = step_cache[(m, r)](
                            state.theta, prev_delta, ids_k[j], keys_k[j])
                    scalars: Dict[str, Any] = {k: (v.tolist() if v.ndim else float(v)) for k, v in metrics.items()}
                info = infos[-1]  # a chain logs its last epoch's prompts
                dt = time.perf_counter() - t0
                epoch = epoch + K - 1  # the chain's last epoch from here on
                registry.inc("dispatches")
                registry.inc("epochs_dispatched", K)
                registry.observe("train_step_time_seconds", dt / K)
                record_device_memory(registry, dev)
                n_images = tc.pop_size * m * r * K
                scalars.update(epoch=epoch, incarnation=int(start_epoch), epochs_chained=K, step_time_s=dt / K,
                               images_scored=n_images, images_per_sec=n_images / max(dt, 1e-9), prompts=info.texts)
                degen_watchdog.update(float(scalars.get("es/fitness_zero", 0.0)) >= 0.5)
                rollback_action = None
                if rollback_ctrl.is_bad(scalars.get("theta_norm")):
                    rollback_action = rollback_ctrl.next_action()
                    state.rollbacks = rollback_ctrl.rollbacks
                    res_registry.inc("rollbacks")
                    print(f"[resilience] WATCHDOG: non-finite/diverged theta at epoch {epoch} "
                          f"(theta_norm={scalars.get('theta_norm')}) — rollback #{rollback_ctrl.rollbacks}, "
                          f"action={rollback_action}", file=sys.stderr, flush=True)
                if quality_ledger is not None:
                    scalars.update(quality_ledger.observe(epoch, scalars))
                scalars.update(registry.snapshot())
                scalars.update(res_registry.snapshot())
                with tracer.span("log"):
                    logger.log(epoch, scalars)

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
        preempt.uninstall()
