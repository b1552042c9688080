"""Preflight: does each rung's ES program fit the card, and how fast could it
go (port of ``hyperscalees_t2i_tpu/tools/preflight.py``).

Usage::

    python -m hyperscalees_t2i_tpu_torch.tools.preflight --rungs flagship
    python -m hyperscalees_t2i_tpu_torch.tools.preflight --rungs tiny,flagship --hbm-gb 4 \\
        --out runs/preflight --report preflight.txt
    python -m hyperscalees_t2i_tpu_torch.tools.preflight --serve flagship:2
    python -m hyperscalees_t2i_tpu_torch.tools.preflight --fleet tiny:2
    python -m hyperscalees_t2i_tpu_torch.tools.preflight --rungs tiny --device cpu --hbm-gb 80

**Measured, not lowered.** The JAX preflight lowers each rung abstractly and
reads XLA's memory and cost analyses on the CPU; the port has no abstract
lowering. It builds the rung on the card (random weights from ``--seed``) and
its ES program as ``train/trainer.make_es_step`` builds it for
``run_training``: an eager warm-up, counted by ``obs/program_cost.CostCounter``
(FLOPs and bytes, each kernel wrapper's calls), then the CUDA graph's
capture. Its peak is the resident bytes (the backend, the reward towers, θ)
plus what ``serve.admission.program_bytes`` measures above them (the graph's
pool and its static buffers): the quantity the serving and fleet gates use.
The counted FLOPs and bytes give the predicted step time at each assumed MFU
(``max(compute at that MFU, the bandwidth floor)``) from the card's tables in
``utils/mfu.py``. A build that raises ``torch.cuda.OutOfMemoryError`` is a
no-fit, reported with the bytes the allocator asked for; no other error is
caught.

``--device cpu`` is for the tests: there the peak is the lower bound
``program_bytes`` gives (inputs and outputs), no card's capacity is known,
and the verdict cannot be judged unless ``--hbm-gb`` names one.

``--serve RUNG:ADAPTERS[:RANK]`` measures a serving geometry through
``serve.admission.analyze_serve_geometry``, ``--fleet RUNG:J`` a fleet program
through ``train.fleet.analyze_fleet_geometry`` beside the rung's own.
``--out DIR`` appends one ``programs.jsonl`` record per program
(``site="preflight"``, ``"serve"``, ``"fleet"``); ``--report`` writes the
text too.

``--devices N`` measures one process's program of the
``parallel.mesh.gcd_pop_data_mesh(pop, N)`` plan (the port's N processes,
one card each): its pop shard's members on its data shard's images, the
reward rows' gathers stood in for by the block tiled to ``[pop, B]``, and
the update, whole or (``--pop_shard_update on``/``auto`` where the base
samples tile the N processes) this process's share of it. Its peak is the
per-device peak. ``--pop_shard_update`` without ``--devices`` above 1
resolves as the trainer does: ``on`` raises, ``auto`` and ``off`` are the
whole update.

Exit codes (the reference's): 1 when a program does not fit, 2 when the fit
cannot be judged (or a geometry is malformed), 0 when everything fits.

Flags of the JAX preflight with no meaning here raise, naming why:
``--remat`` (nothing is differentiated), ``--fused_qlora`` (the int8 base
always runs the fused kernel K3) and ``--chip`` naming a TPU.
"""

from __future__ import annotations

import argparse
import gc
import re
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..obs.program_cost import ProgramLedger, get_ledger, record_program, roofline, set_ledger
from ..rungs import RUNG_ORDER, RUNG_PLAN, knobs_str, rung_opt
from ..utils.mfu import device_kind, hbm_bw_for_kind, hbm_bytes_for_kind, peak_flops_for_kind
from ..ops import kernel_launches

# card kinds in the fit table (rows resolve through utils/mfu.py's tables)
CARDS = ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe")
# assumed-MFU columns of the predicted step-time table (the reference's)
ASSUMED_MFUS = (0.05, 0.10, 0.25, 0.40)
# the Sana scales whose rungs the preflight builds (the JAX preflight's)
SANA_SCALES = ("tiny", "small", "mid", "flagship")
_TPU_KIND = re.compile(r"^(tpu|v[2-9])", re.IGNORECASE)
_OOM_ASK = re.compile(r"Tried to allocate ([0-9.]+) ([KMGT]i?B|B)")
_UNITS = {"B": 1, "KiB": 2**10, "MiB": 2**20, "GiB": 2**30, "TiB": 2**40,
          "KB": 1e3, "MB": 1e6, "GB": 1e9, "TB": 1e12}


def oom_requested_bytes(err: BaseException) -> Optional[float]:
    """The bytes an out-of-memory error says the allocator asked for."""
    m = _OOM_ASK.search(str(err))
    return float(m.group(1)) * _UNITS[m.group(2)] if m else None


def _free(dev: torch.device) -> None:
    # the step's closures keep a backend alive in cycles
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def rung_train_config(rung: str, opt: Dict[str, Any], seed: int = 0):
    """The ``TrainConfig`` of a rung's plan, as ``run_training`` takes it."""
    from ..train.config import TrainConfig

    _, pop, m, member_batch = RUNG_PLAN[rung]
    return TrainConfig(pop_size=pop, sigma=0.01, egg_rank=4, prompts_per_gen=m, batches_per_gen=1,
                       member_batch=member_batch, promptnorm=True, reward_tile=opt["reward_tile"],
                       noise_dtype=opt["noise_dtype"], tower_dtype=opt["tower_dtype"], pop_fuse=opt["pop_fuse"],
                       base_quant=opt["base_quant"], seed=seed)


def per_device_step(backend: Any, reward_fn: Any, tc: Any, m: int, devices: int, sharded: bool, dev: Any,
                    graphs: Any):
    """One process's epoch program of the ``gcd_pop_data_mesh(pop,
    devices)`` plan, as rank 0 of such a launch runs it, in one entry of
    ``graphs``: the draws of the padded batch, its block of members × images
    (``parallel.pop_eval``), the block tiled to the ``[pop, B]`` rows the
    gathers would give, and the update (``sharded``: rank 0's share of the
    contraction, ``parallel.pop_update``, its all-reduce left out). Returns
    ``(step, plan)``; ``step(theta, prev_delta, ids, key)`` is the stateful
    step's signature."""
    from ..parallel.mesh import DATA_AXIS, gcd_pop_data_mesh
    from ..parallel.pop_eval import make_population_evaluator, padded_batch
    from ..parallel.pop_update import make_sharded_es_update
    from ..train.trainer import _capped, _combine_and_update, _scores, es_draws

    es_cfg = tc.es_config()
    pop = tc.pop_size
    plan = gcd_pop_data_mesh(pop, devices, ranks=range(devices))
    eval_pop = make_population_evaluator(backend.generate_p, reward_fn, pop, es_cfg, tc.member_batch,
                                         reward_tile=tc.reward_tile, pop_fuse=tc.pop_fuse, mesh=plan)
    count_pad = padded_batch(m, plan.shape[DATA_AXIS])
    update = make_sharded_es_update(pop, es_cfg, shards=(devices, 0)) if sharded else None
    geo = dict(tc=tc, es_cfg=es_cfg, pop=pop, num_unique=m, repeats=1)

    def core(theta, prev_delta, ids, key):
        noise, gen_noise = es_draws(backend, theta, key, pop, es_cfg, count_pad)
        block = eval_pop(theta, noise, ids, gen_noise.to(torch.float32))
        reps = lambda n, k: -(-n // k)  # noqa: E731
        rows = {k: v.repeat(reps(pop, v.shape[0]), reps(m, v.shape[1]))[:pop, :m] for k, v in block.items()}
        if update is None:
            return _combine_and_update(theta, prev_delta, noise, rows, **geo)
        scores = _scores(rows, tc=tc, pop=pop, num_unique=m, repeats=1)
        theta_new = update.apply(theta, update.partial(theta, noise, scores[3]), noise)
        return _capped(theta, theta_new, prev_delta, rows, scores, **geo)

    def step(theta, prev_delta, ids, key):
        return graphs((m, 1), core, theta, prev_delta, ids, key)

    return step, plan


def analyze_rung(rung: str, device: Any = None, ledger: Optional[ProgramLedger] = None,
                 opt_override: Optional[Dict[str, Any]] = None, seed: int = 0, devices: int = 0,
                 pop_shard_update: Optional[str] = None) -> Dict[str, Any]:
    """Build one rung and its ES program on ``device`` and return its
    ``site="preflight"`` record: the counted FLOPs and bytes, the build's
    stats, ``base_bytes`` + ``program_bytes`` = ``peak_bytes``, the kernel
    launches of the warm-up (``warmup_launches``). On an out-of-memory error
    the record has ``oom`` and ``oom_requested_bytes`` instead of a peak.
    ``devices`` above 1 measures one process's program of the
    ``gcd_pop_data_mesh(pop, devices)`` plan (:func:`per_device_step`; the
    record's ``mesh_shape`` and ``n_devices`` name it), with this process's
    share of the update where ``pop_shard_update`` shards it."""
    from ..parallel.pop_update import pop_shard_update_plan
    from ..backends.sana_backend import build_train_backend
    from ..serve.admission import program_bytes, resident_bytes
    from ..train.trainer import _init_theta, device_ids, epoch_key, make_es_step, program_cache
    from ..utils.pytree import tree_map

    scale, pop, m, member_batch = RUNG_PLAN[rung]
    if scale not in SANA_SCALES:
        raise ValueError(f"preflight builds the Sana rungs; {rung!r} is a {scale} plan")
    opt = rung_opt(rung)
    opt.update({k: v for k, v in (opt_override or {}).items() if v is not None})
    dev = resolve_device(device)
    tc = rung_train_config(rung, opt, seed)
    n_dev = devices if devices and devices > 1 else 1
    # antithetic is the TrainConfig default at every preflight geometry
    sharded, _ = pop_shard_update_plan(pop_shard_update or "off", pop, True, n_pop=n_dev)
    geometry = {"scale": scale, "pop": pop, "m": m, "r": 1, "member_batch": member_batch, **opt}
    if n_dev > 1:
        geometry.update(n_devices=n_dev, pop_shard_update=sharded)
    extra = {"rung": rung, "imgs_per_step": pop * m}
    _free(dev)
    t0 = time.perf_counter()
    before = kernel_launches()
    try:
        backend, reward_fn = build_train_backend(scale, dev, base_quant=opt["base_quant"], seed=seed)
        cache = program_cache(backend, dev, count_cost=True)
        if n_dev > 1:
            step, plan = per_device_step(backend, reward_fn, tc, m, n_dev, sharded, dev, cache)
            geometry["mesh_shape"] = plan.shape
        else:
            step = make_es_step(backend, reward_fn, tc, m, 1, dev, stateful_delta=True, graphs=cache)
        theta = _init_theta(backend, tc, dev)
        args = (theta, tree_map(torch.zeros_like, theta), device_ids(backend.step_info(0, m, 1).flat_ids, dev),
                epoch_key(seed, 0, dev))
        build_s = time.perf_counter() - t0
        base = resident_bytes(backend, dev)
        pool = (lambda: cache.entries[(m, 1)].stats.pool_bytes) if cache.graphed else None
        _, used = program_bytes(step, args, dev, pool)
    except torch.cuda.OutOfMemoryError as e:
        rec = {"site": "preflight", "label": rung, "geometry": geometry, **extra, "oom": True,
               "oom_requested_bytes": oom_requested_bytes(e), "device_kind": device_kind(dev),
               "detail": str(e)[:400]}
        if dev.type == "cuda":
            rec["oom_allocated_bytes"] = float(torch.cuda.memory_allocated(dev))
        if ledger is not None:
            ledger.write(rec)
        _free(dev)
        return rec
    after = kernel_launches()
    entry = cache.entries[(m, 1)]
    extra.update(build_s=build_s, base_bytes=float(base), program_bytes=float(used), peak_bytes=float(base + used),
                 warmup_launches={k: after[k] - before[k] for k in after})
    prev = get_ledger()
    set_ledger(ledger)
    try:
        rec = record_program(site="preflight", label=rung, stats=entry.stats, cost=entry.cost, device=dev,
                             geometry=geometry, extra=extra)
    finally:
        set_ledger(prev)
    del step, cache, args, theta, backend, reward_fn
    _free(dev)
    return rec


def _gb(v: Optional[float]) -> str:
    return f"{v / 1e9:7.2f}" if v is not None else "      ?"


def _col(v: Any, w: int = 9) -> str:
    return f"{str(v):>{w}}"


def _capacity(target: str, hbm_override_bytes: Optional[float]) -> Optional[float]:
    return hbm_override_bytes if hbm_override_bytes is not None else hbm_bytes_for_kind(target)


def _verdict(label: str, peak: Optional[float], cap: Optional[float], rec: Dict[str, Any],
             failures: List[str], unverdicted: List[str]) -> str:
    """The record's cell of the fit gate, appending to the failure or
    cannot-judge list."""
    if rec.get("oom"):
        ask = rec.get("oom_requested_bytes")
        failures.append(f"{label} (out of memory on the card" + (f", asked for {ask / 1e9:.3f} GB more"
                                                                   if ask else "") + ")")
        return "NO-FIT"
    if peak is None or cap is None:
        unverdicted.append(label)
        return "?"
    if peak > cap:
        failures.append(f"{label} (peak {peak / 1e9:.2f} GB > {cap / 1e9:g} GB)")
        return "NO-FIT"
    return "fit"


def render_report(records: List[Dict[str, Any]], target_chip: str,
                  hbm_override_bytes: Optional[float] = None) -> Tuple[str, int]:
    """(report text, exit code) of the rung mode: 1 when a rung does not fit
    the target card (``hbm_override_bytes`` replaces its capacity), 2 when a
    fit cannot be judged, 0 when all fit."""
    lines = ["# Preflight — each rung's ES program built and measured on the card (warm-up counted, then captured)",
             f"# target: {target_chip}  ·  peak = resident bytes + the program's measured bytes "
             "(serve.admission.program_bytes)", ""]
    for r in records:
        g = r.get("geometry", {})
        if g.get("mesh_shape"):
            lines.append(f"# {r.get('rung', '?')}: one process's program of the {g['mesh_shape']} plan over "
                         f"{g['n_devices']} processes (per-device peak; update "
                         f"{'sharded: its share' if g.get('pop_shard_update') else 'whole'})")
    lines.append("## Program cost (per ES step)")
    lines.append("# knobs = <remat>/t<reward tile>/n-<noise dtype>/w-<tower dtype>[/fuse][/q8] (rungs.knobs_str; the "
                 "port rematerializes nothing); FLOPs and bytes counted over the warm-up (obs/program_cost.py)")
    head = ("rung", "geometry", "pop", "knobs", "TFLOP", "GB moved", "base GB", "program GB", "peak GB", "K1", "K3",
            "build s", "warmup s", "capture s")
    lines.append(" ".join(_col(h, 24 if h == "knobs" else 10 if "GB" in h else 9) for h in head))
    for r in records:
        g = r.get("geometry", {})
        flops, bts = r.get("flops"), r.get("bytes_accessed")
        wl = r.get("warmup_launches") or {}
        lines.append(" ".join([
            _col(r.get("rung", r.get("label", "?"))), _col(g.get("scale", "?")), _col(g.get("pop", "?")),
            _col(knobs_str(g), 24), _col(f"{flops / 1e12:.3f}" if flops else "?"),
            _col(f"{bts / 1e9:.2f}" if bts else "?", 10), _col(_gb(r.get("base_bytes")).strip(), 10),
            _col(_gb(r.get("program_bytes")).strip(), 10), _col(_gb(r.get("peak_bytes")).strip(), 10),
            _col(wl.get("int8_matmul", "?")), _col(wl.get("fused_qlora", "?")),
            _col(f"{r['build_s']:.1f}" if r.get("build_s") else "?"),
            _col(f"{r['warmup_s']:.1f}" if r.get("warmup_s") else "?"),
            _col(f"{r['capture_s']:.1f}" if r.get("capture_s") else "?")]))
    lines.append("")

    target_cap = _capacity(target_chip, hbm_override_bytes)
    lines.append("## Device-memory fit (measured peak vs per-card capacity)")
    cap_cols = [(c, hbm_bytes_for_kind(c)) for c in CARDS]
    if target_chip not in CARDS:
        cap_cols.append((target_chip, target_cap))
    cap_cols = [(c, target_cap if c == target_chip else cap) for c, cap in cap_cols]
    lines.append(" ".join([_col("rung")] + [_col(f"{c}({cap / 1e9:g}G)" if cap else c, 26) for c, cap in cap_cols]))
    failures: List[str] = []
    unverdicted: List[str] = []
    for r in records:
        peak = r.get("peak_bytes")
        cells = [_col(r.get("rung", "?"))]
        for _, cap in cap_cols:
            cell = "NO-FIT" if r.get("oom") else "?" if peak is None or cap is None else \
                "fit" if peak <= cap else "NO-FIT"
            cells.append(_col(cell, 26))
        lines.append(" ".join(cells))
        _verdict(str(r.get("rung", "?")), peak, target_cap, r, failures, unverdicted)
    lines.append("")

    peak_f, bw = peak_flops_for_kind(target_chip), hbm_bw_for_kind(target_chip)
    if peak_f and bw:
        lines.append(f"## Predicted step time on {target_chip} ({peak_f / 1e12:.0f} TFLOP/s bf16, {bw / 1e9:.0f} GB/s "
                     "HBM, 1 card) — max(compute@MFU, bandwidth floor)")
        lines.append(" ".join([_col("rung")] + [_col(f"@MFU {u:.2f}") for u in ASSUMED_MFUS]
                              + [_col("bw floor s", 11), _col("bound")]))
        for r in records:
            flops, bts = r.get("flops"), r.get("bytes_accessed")
            rf = roofline(flops, bts, peak_flops=peak_f, hbm_bw=bw)
            cells = [_col(r.get("rung", "?"))]
            for u in ASSUMED_MFUS:
                cells.append(_col(f"{max(flops / (peak_f * u), rf['t_bandwidth_s'] or 0.0):.4f}" if flops else "?"))
            cells.append(_col(f"{rf['t_bandwidth_s']:.4f}" if rf["t_bandwidth_s"] else "?", 11))
            cells.append(_col(rf["bound"] or "?"))
            lines.append(" ".join(cells))
        lines.append("")
    return _close(lines, failures, unverdicted, f"VERDICT: NO-FIT on {target_chip}: ",
                  f"cannot evaluate the fit on {target_chip} for: ", f"VERDICT: all analyzed rungs fit {target_chip}")


def _close(lines: List[str], failures: List[str], unverdicted: List[str], no_fit: str, cannot: str,
           ok: str) -> Tuple[str, int]:
    if failures:
        lines.append(no_fit + ", ".join(failures))
        rc = 1
    elif unverdicted:
        lines.append("VERDICT: " + cannot + ", ".join(unverdicted)
                     + " (unknown capacity or peak — pass --hbm-gb for the CPU or an unlisted card)")
        rc = 2
    else:
        lines.append(ok)
        rc = 0
    return "\n".join(lines) + "\n", rc


def render_serve_report(records: List[Dict[str, Any]], target_chip: str,
                        hbm_override_bytes: Optional[float] = None) -> Tuple[str, int]:
    """(report text, exit code) of ``--serve``: the admission gate's answer
    per geometry, with the reference's exit codes."""
    target_cap = _capacity(target_chip, hbm_override_bytes)
    lines = ["# Serving preflight — the adapter-batched generate program measured at probe lanes and extrapolated "
             "(serve/admission.py)",
             f"# target: {target_chip} — admission verdict for serve/ServeEngine geometries (site=\"serve\" records)",
             "", " ".join([_col("geometry", 20), _col("A"), _col("B"), _col("rank"), _col("probes", 22),
                           _col("base GB", 10), _col("program GB", 10), _col("peak GB", 10), _col("verdict", 8)])]
    failures: List[str] = []
    unverdicted: List[str] = []
    for r in records:
        g = r.get("geometry", {})
        verdict = _verdict(str(r.get("label", "?")), r.get("peak_bytes"), target_cap, r, failures, unverdicted)
        probes = ",".join(f"{n}:{v / 1e9:.3f}" for n, v in sorted((r.get("probe_bytes") or {}).items()))
        lines.append(" ".join([
            _col(r.get("label", "?"), 20), _col(g.get("adapter_batch", "?")), _col(g.get("images_per_request", "?")),
            _col(g.get("lora_rank") or "dflt"), _col(probes or "—", 22), _col(_gb(r.get("base_bytes")).strip(), 10),
            _col(_gb(r.get("program_bytes")).strip(), 10), _col(_gb(r.get("peak_bytes")).strip(), 10),
            _col(verdict, 8)]))
    lines.append("")
    return _close(lines, failures, unverdicted, f"VERDICT: serve admission REFUSED on {target_chip}: ",
                  f"cannot evaluate serve fit on {target_chip} for: ",
                  f"VERDICT: all serving geometries ADMITTED on {target_chip}")


def render_fleet_report(pairs: List[Tuple[Dict[str, Any], Dict[str, Any]]], target_chip: str,
                        hbm_override_bytes: Optional[float] = None) -> Tuple[str, int]:
    """(report text, exit code) of ``--fleet``: each W-job program's fit
    beside the rung's single-job program. 1 when a fleet does not fit, 2
    when a fit cannot be judged, 0 otherwise. The port's fleet runs each
    job's population as its solo step does (W jobs cost W solo epochs), so
    the reference's amortization test of the bytes moved has no counterpart:
    the table shows the single-job peak beside the fleet's."""
    target_cap = _capacity(target_chip, hbm_override_bytes)
    lines = ["# Fleet preflight — the W-job ES program built and measured on the card (train/fleet.py)",
             f"# target: {target_chip} — admission verdict for train/fleet.FleetScheduler geometries "
             "(site=\"fleet\" records)", "",
             " ".join([_col("geometry", 18), _col("J"), _col("base GB", 10), _col("program GB", 10),
                       _col("peak GB", 10), _col("solo peak GB", 12), _col("verdict", 8)])]
    failures: List[str] = []
    unverdicted: List[str] = []
    for fleet_rec, solo_rec in pairs:
        label = str(fleet_rec.get("label", "?"))
        verdict = _verdict(label, fleet_rec.get("peak_bytes"), target_cap, fleet_rec, failures, unverdicted)
        lines.append(" ".join([
            _col(label, 18), _col(fleet_rec.get("fleet_width", "?")), _col(_gb(fleet_rec.get("base_bytes")).strip(), 10),
            _col(_gb(fleet_rec.get("program_bytes")).strip(), 10), _col(_gb(fleet_rec.get("peak_bytes")).strip(), 10),
            _col(_gb(solo_rec.get("peak_bytes")).strip(), 12), _col(verdict, 8)]))
    lines.append("")
    return _close(lines, failures, unverdicted, f"VERDICT: fleet admission REFUSED on {target_chip}: ",
                  f"cannot evaluate fleet fit on {target_chip} for: ",
                  f"VERDICT: all fleet geometries ADMITTED on {target_chip}")


def _refuse(args: argparse.Namespace) -> None:
    if args.remat is not None:
        raise NotImplementedError("--remat: the port differentiates nothing, so it has no rematerialization")
    if args.fused_qlora is not None:
        raise NotImplementedError("--fused_qlora: the port's int8 base always runs the fused kernel (K3); the "
                                  "unfused composition is the JAX package's reference program")
    if args.chip and _TPU_KIND.match(args.chip):
        raise NotImplementedError(f"--chip {args.chip}: a TPU kind; the port measures on a CUDA card "
                                  f"(known: {', '.join(CARDS)})")


def _emit(report: str, path: Optional[str]) -> None:
    print(report, end="")
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(report)
        print(f"[preflight] report → {path}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rungs", default=",".join(RUNG_ORDER), help="comma list of rungs (default: the ladder)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu (tests: the peak is a lower bound)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights and the first epoch's key")
    ap.add_argument("--chip", default=None,
                    help="target card kind of the verdict (default: this device's name); a TPU kind raises")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="the target's device memory in GB (an unlisted card, the CPU, or the no-fit path)")
    ap.add_argument("--reward_tile", type=int, default=None, help="override the rung's member-interior reward tile")
    ap.add_argument("--noise_dtype", default=None, choices=["float32", "bfloat16", "bf16"],
                    help="override the rung's ES-noise dtype")
    ap.add_argument("--tower_dtype", default=None, choices=["float32", "bfloat16", "bf16"],
                    help="override the rung's reward-tower dtype")
    ap.add_argument("--pop_fuse", default=None, choices=["on", "off"], help="override the factored member path")
    ap.add_argument("--base_quant", default=None, choices=["off", "int8"], help="override the frozen base's storage")
    ap.add_argument("--remat", default=None, help="refused: nothing is differentiated")
    ap.add_argument("--fused_qlora", default=None, help="refused: the int8 base always runs K3")
    ap.add_argument("--pop_shard_update", default=None, choices=["auto", "on", "off"],
                    help="with --devices N: measure this process's share of the pop-sharded update (on/auto) or the "
                         "whole update (off, the default)")
    ap.add_argument("--devices", type=int, default=0,
                    help="measure one process's program of the gcd_pop_data_mesh(pop, N) plan over N processes")
    ap.add_argument("--serve", action="append", default=None, metavar="RUNG:ADAPTERS[:RANK]",
                    help="serving-admission mode (repeatable): measure this serving geometry's program instead of "
                         "the training rungs")
    ap.add_argument("--serve_images", type=int, default=None, help="images per request for --serve geometries")
    ap.add_argument("--fleet", action="append", default=None, metavar="RUNG:J",
                    help="fleet-admission mode (repeatable): measure the J-job fleet program beside the rung's own")
    ap.add_argument("--out", default=None, help="dir to append ledger records to (<out>/programs.jsonl)")
    ap.add_argument("--report", default=None, help="also write the report text to this path")
    args = ap.parse_args(argv)
    _refuse(args)

    dev = resolve_device(args.device)
    target = args.chip or device_kind(dev)
    hbm_override = args.hbm_gb * 1e9 if args.hbm_gb is not None else None
    ledger = ProgramLedger(Path(args.out) / "programs.jsonl") if args.out else None
    opt_override = {"reward_tile": args.reward_tile, "noise_dtype": args.noise_dtype, "tower_dtype": args.tower_dtype,
                    "pop_fuse": None if args.pop_fuse is None else args.pop_fuse == "on",
                    "base_quant": args.base_quant}

    if args.serve:
        from ..serve.admission import analyze_serve_geometry, parse_serve_geometry

        records = []
        for spec in args.serve:
            try:
                rung, adapters, rank = parse_serve_geometry(spec)
            except ValueError as e:
                print(f"[preflight] {e}", file=sys.stderr)
                return 2
            print(f"[preflight] serve {spec}: building and measuring ...", file=sys.stderr, flush=True)
            records.append(analyze_serve_geometry(rung, adapters, images_per_request=args.serve_images, rank=rank,
                                                  device=dev, ledger=ledger, seed=args.seed))
            _free(dev)
        report, rc = render_serve_report(records, target, hbm_override)
        _emit(report, args.report)
        return rc

    if args.fleet:
        from ..train.fleet import analyze_fleet_geometry, parse_fleet_geometry

        pairs = []
        solo: Dict[str, Dict[str, Any]] = {}
        for spec in args.fleet:
            try:
                rung, width = parse_fleet_geometry(spec)
            except ValueError as e:
                print(f"[preflight] {e}", file=sys.stderr)
                return 2
            if rung not in solo:
                print(f"[preflight] fleet {spec}: single-job program ...", file=sys.stderr, flush=True)
                solo[rung] = analyze_rung(rung, dev, ledger, opt_override, args.seed)
            print(f"[preflight] fleet {spec}: the {width}-job program ...", file=sys.stderr, flush=True)
            rec = analyze_fleet_geometry(rung, width, dev, opt_override, args.seed)
            if ledger is not None:
                ledger.write(rec)
            _free(dev)
            pairs.append((rec, solo[rung]))
        report, rc = render_fleet_report(pairs, target, hbm_override)
        _emit(report, args.report)
        return rc

    rungs = [r.strip() for r in args.rungs.split(",") if r.strip()]
    unknown = [r for r in rungs if r not in RUNG_PLAN or RUNG_PLAN[r][0] not in SANA_SCALES]
    if unknown:
        print(f"unknown rungs: {unknown} (have: {sorted(r for r, p in RUNG_PLAN.items() if p[0] in SANA_SCALES)})",
              file=sys.stderr)
        return 2
    records = []
    for rung in rungs:
        print(f"[preflight] {rung}: building and measuring ...", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        records.append(analyze_rung(rung, dev, ledger, opt_override, args.seed, devices=args.devices,
                                    pop_shard_update=args.pop_shard_update))
        print(f"[preflight] {rung}: done in {time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
    report, rc = render_report(records, target, hbm_override)
    _emit(report, args.report)
    return rc


if __name__ == "__main__":
    sys.exit(main())
