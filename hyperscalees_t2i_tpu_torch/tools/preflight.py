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

Exit codes (the reference's): 1 when a program does not fit, 2 when the fit
cannot be judged (or a geometry is malformed), 0 when everything fits.

Flags of the JAX preflight with no meaning here raise, naming why:
``--devices`` above 1 and ``--pop_shard_update`` (the sharded programs and
the update isolation are ROADMAP item 7), ``--remat`` (nothing is
differentiated), ``--fused_qlora`` (the int8 base always runs the fused
kernel K3) and ``--chip`` naming a TPU.
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
from ..rungs import RUNG_ORDER, RUNG_PLAN, rung_opt
from ..utils.mfu import device_kind, hbm_bw_for_kind, hbm_bytes_for_kind, peak_flops_for_kind

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


def _launches() -> Dict[str, int]:
    """The kernel wrappers' launch counters (kernels launched on the card;
    the CPU's plain versions count nothing)."""
    from ..ops.attention import decode_attention
    from ..ops.fused_lora import member_lora_delta
    from ..ops.fused_qlora import fused_qlora_matmul
    from ..ops.quant_mm import int8_matmul

    return {"int8_matmul": int8_matmul.launches, "lora_chain": member_lora_delta.launches,
            "fused_qlora": fused_qlora_matmul.launches, "decode_attention": decode_attention.launches}


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


def analyze_rung(rung: str, device: Any = None, ledger: Optional[ProgramLedger] = None,
                 opt_override: Optional[Dict[str, Any]] = None, seed: int = 0) -> Dict[str, Any]:
    """Build one rung and its ES program on ``device`` and return its
    ``site="preflight"`` record: the counted FLOPs and bytes, the build's
    stats, ``base_bytes`` + ``program_bytes`` = ``peak_bytes``, the kernel
    launches of the warm-up (``warmup_launches``). On an out-of-memory error
    the record has ``oom`` and ``oom_requested_bytes`` instead of a peak."""
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
    geometry = {"scale": scale, "pop": pop, "m": m, "r": 1, "member_batch": member_batch, **opt}
    extra = {"rung": rung, "imgs_per_step": pop * m}
    _free(dev)
    t0 = time.perf_counter()
    before = _launches()
    try:
        backend, reward_fn = build_train_backend(scale, dev, base_quant=opt["base_quant"], seed=seed)
        cache = program_cache(backend, dev, count_cost=True)
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
    after = _launches()
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


def knobs_str(g: Dict[str, Any]) -> str:
    """The knobs of a geometry in one token, ``t<tile>/n-<dt>/w-<dt>`` plus
    ``/fuse`` and ``/q8`` (the reference's, less its remat field)."""
    def dt(v: Any) -> str:
        return "bf16" if str(v).startswith("bf") else "f32"

    marks = "".join(m for m, on in (("/fuse", g.get("pop_fuse")), ("/q8", g.get("base_quant") == "int8")) if on)
    return (f"t{g.get('reward_tile', 0)}/n-{dt(g.get('noise_dtype', 'float32'))}"
            f"/w-{dt(g.get('tower_dtype', 'float32'))}{marks}")


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
    lines.append("## Program cost (per ES step)")
    lines.append("# knobs = t<reward tile>/n-<noise dtype>/w-<tower dtype>[/fuse][/q8]; FLOPs and bytes counted over "
                 "the warm-up (obs/program_cost.py)")
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
    if args.devices and args.devices > 1:
        raise NotImplementedError("--devices > 1: the sharded programs and the update isolation are ROADMAP item 7 "
                                  "(the port runs one process on one card)")
    if args.pop_shard_update is not None:
        raise NotImplementedError("--pop_shard_update: the pop-sharded update is ROADMAP item 7")
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
    ap.add_argument("--pop_shard_update", default=None, help="refused: ROADMAP item 7")
    ap.add_argument("--devices", type=int, default=0, help="refused above 1: ROADMAP item 7")
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
        records.append(analyze_rung(rung, dev, ledger, opt_override, args.seed))
        print(f"[preflight] {rung}: done in {time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
    report, rc = render_report(records, target, hbm_override)
    _emit(report, args.report)
    return rc


if __name__ == "__main__":
    sys.exit(main())
