"""The rung runner: ES images scored per second at each geometry rung (port of
the root ``bench.py``)::

    python -m hyperscalees_t2i_tpu_torch.tools.bench                     # the ladder, on the card
    BENCH_RUNGS=tiny,flaggen,flagship python -m hyperscalees_t2i_tpu_torch.tools.bench
    python -m hyperscalees_t2i_tpu_torch.tools.bench --rung flagship     # one rung, in this process
    python -m hyperscalees_t2i_tpu_torch.tools.bench --serve --rung flagship --batches 2
    python -m hyperscalees_t2i_tpu_torch.tools.bench --fleet --rung tiny --widths 1,2
    python -m hyperscalees_t2i_tpu_torch.tools.bench --scaling --rungs tiny --devices 1,2
    python -m hyperscalees_t2i_tpu_torch.tools.bench --device cpu ...    # the CPU, as the tests run it

A rung is a plan of ``rungs.RUNG_PLAN`` (scale, population, prompts,
member_batch) at its ``RUNG_OPT`` knobs: the Sana rungs (``tiny`` …
``flagpop``, and ``flaggen``, the flagship's generator alone at the
flagship's tiling: flagship − flaggen is the decode-and-reward share of an
epoch), VAR (``ar``, the JAX
runner's cut geometry, and ``ar_d16``) and Infinity-2B (``inf_2b``). Weights
are random, drawn from the JAX runner's keys. Each rung's ES step is
``train.trainer.make_es_step``'s program, the step ``run_training`` runs.

The honesty contract:

- The step's first call is its eager warm-up, counted by
  ``obs.program_cost.CostCounter`` (its FLOPs and bytes), then its CUDA
  graph's capture: ``compile_s`` is the two, and the record carries the
  graph's pool bytes. One replay (``warmup_step_s``) follows, then the
  timed windows: ``BENCH_STEPS`` single-dispatch replays, each read back
  (``run_training`` at ``steps_per_dispatch`` 1), and, where
  ``RUNG_CHAIN`` is above 1, that many chained replays with one read-back
  (``steps_per_dispatch`` K). θ chains through every timed step and each
  window ends in a read-back of ``opt_score_mean``, which depends on all
  its steps, so the clock cannot stop at a launch.
- MFU and ``step_tflops`` come from the counted FLOPs and the card's peak
  (``utils/mfu.py``); a rung above MFU 1 is refused by the parent, and a
  step faster than its physical floor (:func:`physical_floor_check`: the
  counted FLOPs, else :func:`analytic_floor_flops`, at the card's peak)
  raises in the child. ``roofline_bound`` and ``predicted_step_time_s``
  come from the counted FLOPs and bytes.
- ``kernel_launches`` holds the K1-K4 wrappers' counters over the warm-up
  step; a rung whose plan runs a kernel raises if the card launched none.
  ``kernel_parity_maxdiff`` (``ar`` rungs) is K4 against its plain version
  at the rung's shapes on the card, with ``kernel_parity_rel`` (a call's
  largest difference over its largest plain output, the measure of the
  kernel checks in ``chip_smoke.py``) and ``kernel_parity_ref_abs`` (the
  plain output's magnitude where the difference is largest).
- The parent imports no torch. It runs the rungs in one child that streams
  a JSON line per rung (heartbeats on stderr, ``obs/heartbeat.py``), keeps
  the budget (``BENCH_BUDGET_S``) and a per-rung stall cap
  (:func:`rung_stall_cap`), respawns a child for the rungs a stalled one
  left, and prints one final JSON line. Its children die with it
  (``launch_local.die_with_parent``).
  A child that prints nothing is an error and exit 1: the runner never
  moves the rungs to the CPU because the card was slow or absent. The CPU
  runs only where ``--device cpu`` names it.

Record fields of the JAX runner with no counterpart here: the StableHLO
fields, the collective fields, ``compile_cache_*``, ``lowering_s`` (there
is no lowering: the warm-up is eager) are null; ``pallas_env``,
``pallas_probes`` and ``fused_qlora`` are replaced by ``kernel_launches``,
``jax_version`` by ``torch_version``.

Environment: ``BENCH_TINY=1`` (the tiny rung only), ``BENCH_BUDGET_S``
(default 540), ``BENCH_STEPS`` (3), ``BENCH_CHAIN`` (replays a chained
window; 0 disables), ``BENCH_RUNGS`` (comma list), ``BENCH_PROGRAMS_JSONL``
(the ledger, default ``bench_runs/programs.jsonl``), ``BENCH_POP``/
``BENCH_PROMPTS`` (a direct ``--rung`` only). ``--profile DIR`` records a
``torch.profiler`` window around each rung's single-dispatch replays into
``DIR/<rung>/``, each replay in a ``bench/<rung>`` range that
``obs/calib.py`` joins to the rung's ledger record. ``--compile_cache`` is
refused: a CUDA graph cannot be serialized.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..obs.heartbeat import Heartbeat, emit_heartbeat
from ..ops import kernel_launches
from ..rungs import (
    RUNG_CHAIN,
    RUNG_CHAIN_FIT_GATED,
    RUNG_EST_S,
    RUNG_ORDER,
    RUNG_PLAN,
    SCALING_DEVICE_COUNTS,
    SERVE_PLAN,
    rung_opt,
)
from .launch_local import die_with_parent

REPO = Path(__file__).resolve().parents[2]
MODULE = "hyperscalees_t2i_tpu_torch.tools.bench"
# the JAX runner's estimate of the reference's sequential loop on one A100
# (one-step 1.6B DiT + 1024px decode + CLIP/PickScore per image); labelled
# estimated, claimed only at the flagship on the card
BASELINE_IMGS_PER_SEC = 3.0
# the JAX runner's schema: version 4 has the digest and collective fields
BENCH_SCHEMA_VERSION = 4
# scales of the VAR and Infinity rungs (the others are Sana's)
VAR_SCALES = ("ar_small", "d16")
INFINITY_SCALES = ("2b",)
# the order in which a completed rung becomes the headline (the JAX runner's)
HEADLINE_ORDER = ["tiny", "small", "popscale", "mid", "midpop", "flagship", "flagpop"]
KERNELS = ("int8_matmul", "lora_chain", "fused_qlora", "decode_attention")

_T0 = time.perf_counter()


def _log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# pure helpers (no torch)
# ---------------------------------------------------------------------------

def physical_floor_check(step_time_s, floor_flops, peak_flops, n_dev) -> Optional[str]:
    """The error string when a measured step time is below the physical
    floor ``floor_flops / (peak · n_dev)`` (timing that is not
    execution-synced); None when plausible or when the gate cannot arm (no
    peak, no FLOPs)."""
    if peak_flops is None or not floor_flops or floor_flops <= 0:
        return None
    floor_s = floor_flops / (peak_flops * max(n_dev, 1))
    if step_time_s < floor_s:
        return (
            f"IMPOSSIBLE: step_time {step_time_s:.6g}s < physical floor "
            f"{floor_s:.6g}s ({floor_flops / 1e12:.4g} TFLOP at peak) — "
            f"timing is not execution-synced"
        )
    return None


@functools.lru_cache(maxsize=1)
def card_stamp() -> Dict[str, Optional[str]]:
    """``device_name`` and ``power_limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them for the
    first card; nulls where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return {"device_name": None, "power_limit": None}
    line = out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""
    name, _, limit = line.rpartition(",")
    return {"device_name": name.strip() or None, "power_limit": limit.strip() or None}


def artifact_stamp() -> Dict[str, Any]:
    """The provenance stamp of every record and artifact: schema version,
    torch's version (package metadata: no torch import), the checkout's
    short git sha, and the card's name and power limit."""
    try:
        from importlib.metadata import version

        torch_version = version("torch")
    except Exception:
        torch_version = None
    return {"schema_version": BENCH_SCHEMA_VERSION, "torch_version": torch_version, "git_sha": git_sha(short=True),
            **card_stamp()}


def git_sha(short: bool = False) -> Optional[str]:
    """The checkout's HEAD (``--short``: its abbreviated form), or None
    outside a git checkout."""
    try:
        out = subprocess.run(["git", "rev-parse", *(["--short"] if short else []), "HEAD"], cwd=REPO,
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None if out.returncode == 0 else None


def plan_kernels(rung: str) -> List[str]:
    """The kernels a rung's plan runs on the card: K1 at every int8 site,
    K3 (int8 base) or K2 (float base) at the adapted sites of the factored
    member path, K4 in every VAR and Infinity attention."""
    scale = RUNG_PLAN[rung][0]
    opt = rung_opt(rung)
    out = []
    if opt["base_quant"] == "int8":
        out.append("int8_matmul")
    if opt["pop_fuse"]:
        out.append("fused_qlora" if opt["base_quant"] == "int8" else "lora_chain")
    if scale in VAR_SCALES + INFINITY_SCALES:
        out.append("decode_attention")
    return out


# ---------------------------------------------------------------------------
# child: one rung, honestly timed
# ---------------------------------------------------------------------------

def _device(device: Any = None):
    from ..device import resolve_device

    return resolve_device(device if device is not None else (os.environ.get("BENCH_DEVICE") or None))


def build_rung(rung: str, device: Any, base_quant: Optional[str] = None):
    """The rung's backend and reward function, as the JAX runner builds
    them: Sana rungs through ``sana_backend.build_train_backend`` (the
    rung's base unless ``base_quant`` names another), ``ar``/``ar_d16``
    through ``var_backend``'s, ``inf_2b`` through ``infinity_backend``'s."""
    scale = RUNG_PLAN[rung][0]
    opt = rung_opt(rung)
    base_quant = opt["base_quant"] if base_quant is None else base_quant
    if scale in VAR_SCALES:
        from ..backends.var_backend import build_train_backend

        return build_train_backend(scale, device, seed=0)
    if scale in INFINITY_SCALES:
        from ..backends.infinity_backend import build_train_backend

        return build_train_backend(scale, device, seed=0, base_quant=base_quant)
    from ..backends.sana_backend import build_train_backend

    return build_train_backend(scale, device, base_quant=base_quant, seed=0)


def frozen_tensors(*objs: Any) -> List[Any]:
    """Every tensor a step reads without taking it as an input: the
    parameters and buffers of each object's modules and its tensor
    attributes (a backend, a reward suite)."""
    import torch

    out, seen = [], set()
    for obj in objs:
        for v in vars(obj).values() if hasattr(obj, "__dict__") else ():
            ts = list(v.parameters()) + list(v.buffers()) if isinstance(v, torch.nn.Module) else \
                [v] if isinstance(v, torch.Tensor) else []
            for t in ts:
                if id(t) not in seen and t.device.type != "meta":
                    seen.add(id(t))
                    out.append(t)
    return out


def analytic_floor_flops(tensors: Sequence[Any], imgs: int) -> float:
    """A lower bound on one ES step's FLOPs, independent of the counter:
    every scored image runs at least one forward in which every float
    value of ``tensors`` (the frozen trees and θ) takes part in one
    multiply-add (2 FLOPs)."""
    n = sum(int(t.numel()) for t in tensors if t.is_floating_point())
    return 2.0 * n * max(imgs, 1)


def _tree_tensors(tree: Any) -> List[Any]:
    from ..utils.pytree import tree_leaves

    return list(tree_leaves(tree))


def _cache_totals(cache: Any) -> Dict[str, Any]:
    """The programs of a graph cache summed: counted FLOPs and bytes, warm-up,
    capture and instantiate seconds, pool bytes."""
    tot = {"flops": 0.0, "bytes_accessed": 0.0, "warmup_s": 0.0, "capture_s": 0.0, "instantiate_s": 0.0,
           "pool_bytes": 0}
    for e in cache.entries.values():
        for k in ("flops", "bytes_accessed"):
            tot[k] += float((e.cost or {}).get(k) or 0.0)
        for k in ("warmup_s", "capture_s", "instantiate_s", "pool_bytes"):
            tot[k] += getattr(e.stats, k)
    return tot


def kernel_parity(backend: Any, rung: str, device: Any) -> Optional[Dict[str, float]]:
    """|K4 − its plain version| at the rung's attention shapes on the
    card: every scale's queries (``p²``) against the KV-cache prefix up to
    that scale, with the rows of one generate call (lanes × prompts × 2 for
    CFG), the model's heads, head width and dtype, on inputs like the
    path's (QK-l2: unit keys, queries of norm 4, the initial log-4 scale,
    softmax scale 1; normal values). Returns the largest difference
    (``maxdiff``), the plain output's magnitude where it falls (``ref_abs``)
    and, over the calls, the largest of a call's largest difference over
    its largest plain output (``rel``): the kernel's error follows the
    values' scale, not each output's, since an output can be small by
    cancellation. None on the CPU, where no kernel runs; these launches are
    not counted."""
    import torch

    from ..models.nn import l2_normalize
    from ..ops.attention import decode_attention, naive_masked_attention
    from ..utils import threefry

    if torch.device(device).type != "cuda":
        return None
    cfg = backend.cfg.model
    _, _, m, mb = RUNG_PLAN[rung]
    rows = 2 * mb * m
    L, H, dh, dt = cfg.seq_len, cfg.n_heads, cfg.head_dim, cfg.compute_dtype
    kq, kk, kv = threefry.split(threefry.prng_key(42, device), 3)
    k = l2_normalize(threefry.normal(kk, (rows, L, H, dh))).to(dt)
    v = threefry.normal(kv, (rows, L, H, dh)).to(dt)
    worst, end = {"maxdiff": 0.0, "ref_abs": 0.0, "rel": 0.0}, 0
    launches = decode_attention.launches
    for p in cfg.patch_nums:
        end += p * p
        q = (l2_normalize(threefry.normal(threefry.fold_in(kq, p), (rows, p * p, H, dh))) * 4.0).to(dt)
        a = decode_attention(q, k, v, kv_len=end, sm_scale=1.0)
        b = naive_masked_attention(q, k, v, end, None, 1.0)
        diff, ref = (a.float() - b.float()).abs().flatten(), b.float().abs().flatten()
        i = int(diff.argmax())
        if float(diff[i]) > worst["maxdiff"]:
            worst.update(maxdiff=float(diff[i]), ref_abs=float(ref[i]))
        worst["rel"] = max(worst["rel"], float(diff[i] / ref.max()))
    decode_attention.launches = launches
    return worst


def _make_step(backend: Any, reward: Any, tc: Any, num_unique: int, dev: Any, cache: Any):
    """The rung's stateful epoch step: ``make_es_step`` in one process; in a
    launch of several (``--scaling``), this process's member slice
    (``make_host_sharded_programs``) around the host gather of the rows."""
    from ..parallel.collectives import process_count, process_rank
    from ..parallel.mesh import host_slices
    from ..train.trainer import _host_step, make_es_step, make_host_sharded_programs

    n = process_count()
    if n <= 1:
        return make_es_step(backend, reward, tc, num_unique, 1, dev, stateful_delta=True, graphs=cache)
    host_slice = host_slices(tc.pop_size, n)[process_rank()]
    return _host_step(*make_host_sharded_programs(backend, reward, tc, num_unique, 1, host_slice, dev,
                                                  graphs=cache))


def run_rung(rung: str, device: Any = None, allow_env_overrides: bool = True) -> Dict[str, Any]:
    """Build, warm up, capture and time one rung on ``device`` (default:
    ``$BENCH_DEVICE``, else the card); returns its record."""
    import torch

    from ..obs.profile_trace import start_profile, stop_profile
    from ..obs.program_cost import record_program, roofline
    from ..parallel.collectives import process_count
    from ..train.config import TrainConfig
    from ..train.trainer import device_ids, program_cache
    from ..utils import threefry
    from ..utils.mfu import device_hbm_bandwidth, device_kind, device_peak_flops, hbm_bytes_for_kind
    from ..utils.pytree import tree_map

    dev = _device(device)
    cuda = dev.type == "cuda"
    scale, pop, m, member_batch = RUNG_PLAN[rung]
    if allow_env_overrides:
        pop = int(os.environ.get("BENCH_POP", pop))
        m = int(os.environ.get("BENCH_PROMPTS", m))
    steps = int(os.environ.get("BENCH_STEPS", "3"))
    opt = rung_opt(rung)
    n_proc = process_count()

    _log(f"{rung}: building (scale={scale} pop={pop} m={m} tile={opt['reward_tile']} noise={opt['noise_dtype']} "
         f"towers={opt['tower_dtype']} fuse={opt['pop_fuse']} base={opt['base_quant']}) on {dev}")
    t_build0 = time.perf_counter()
    with Heartbeat(rung, "build"):
        backend, reward = build_rung(rung, dev)
        tc = TrainConfig(pop_size=pop, sigma=0.01, egg_rank=4, prompts_per_gen=m, batches_per_gen=1,
                         member_batch=member_batch, promptnorm=True, reward_tile=opt["reward_tile"],
                         noise_dtype=opt["noise_dtype"], tower_dtype=opt["tower_dtype"], pop_fuse=opt["pop_fuse"],
                         base_quant=opt["base_quant"], quality=False)
        num_unique = min(m, backend.num_items)
        cache = program_cache(backend, dev, count_cost=True)
        step = _make_step(backend, reward, tc, num_unique, dev, cache)
        theta = tree_map(lambda t: t.to(dev), backend.init_theta(threefry.prng_key(1, dev)))
        delta = tree_map(torch.zeros_like, theta)
        ids = device_ids(backend.step_info(0, num_unique, 1).flat_ids, dev)
        if cuda:
            torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t_build0
    imgs_per_step = pop * num_unique

    # the first call: the eager warm-up (counted), then the graph's capture
    _log(f"{rung}: built in {build_s:.1f}s; warm-up and capture")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernel_launches()
    t_c0 = time.perf_counter()
    with Heartbeat(rung, "compile"):
        theta, delta, metrics, opt_s = step(theta, delta, ids, threefry.prng_key(2, dev))
        float(metrics["opt_score_mean"])
    compile_s = time.perf_counter() - t_c0
    after = kernel_launches()
    launches = {k: after[k] - before[k] for k in KERNELS}
    if cuda:
        missing = [k for k in plan_kernels(rung) if not launches[k]]
        if missing:
            raise RuntimeError(f"{rung}: the plan runs {missing} but the card launched none of them "
                               f"(launches over the warm-up step: {launches})")
    # the reward-parity anchor: the warm-up step's per-member scores from a
    # fresh θ and a fixed key, equal at every process count (--scaling)
    opt_scores = opt_s.detach().to("cpu", torch.float32).numpy()
    opt_scores_digest = hashlib.sha256(opt_scores.astype("<f4").tobytes()).hexdigest()[:16]
    totals = _cache_totals(cache)
    step_flops = totals["flops"] or None
    step_bytes = totals["bytes_accessed"] or None

    # one replay (its outputs dropped: θ and Δθ stay the warm-up's)
    t_w0 = time.perf_counter()
    with Heartbeat(rung, "warmup", gauges=None):
        _, _, m1, _ = step(theta, delta, ids, threefry.fold_in(threefry.prng_key(4, dev), 0))
        float(m1["opt_score_mean"])
    warm_s = time.perf_counter() - t_w0
    if warm_s > 60 and steps > 1:
        steps = 1
    keys = [threefry.fold_in(threefry.prng_key(3, dev), e) for e in range(steps)]

    _log(f"{rung}: compile {compile_s:.1f}s, replay {warm_s:.2f}s; timing {steps} single-dispatch steps")
    profile_dir = os.environ.get("BENCH_PROFILE_DIR") or None
    prof = None
    if profile_dir:
        profile_dir = os.path.join(profile_dir, rung)
        prof = start_profile(dev)
        _log(f"{rung}: profiling the single-dispatch steps -> {profile_dir}")
    t0 = time.perf_counter()
    try:
        with Heartbeat(rung, "timed", gauges=None):
            for e in range(steps):
                with torch.profiler.record_function(f"bench/{rung}") if prof is not None else contextlib.nullcontext():
                    theta, delta, metrics, _ = step(theta, delta, ids, keys[e])
                    # θ chains through every step: this read-back cannot
                    # return before every timed step ran
                    score = float(metrics["opt_score_mean"])
    finally:
        if prof is not None:
            stop_profile(prof, os.path.join(profile_dir, "bench.pt.trace.json"))
    step_time = (time.perf_counter() - t0) / steps

    peak_bytes = None
    if cuda:
        peak_bytes = float(torch.cuda.max_memory_allocated(dev) + totals["pool_bytes"])
    chain = int(os.environ.get("BENCH_CHAIN", RUNG_CHAIN.get(rung, 0)))
    if n_proc > 1:
        chain = 0  # a host-sharded epoch reads its rows back every step
    if chain > 1 and warm_s > 60 and "BENCH_CHAIN" not in os.environ:
        _log(f"{rung}: replay {warm_s:.0f}s > 60s: no chained window (set BENCH_CHAIN to force it)")
        chain = 0
    cap = hbm_bytes_for_kind(device_kind(dev))
    if chain > 1 and rung in RUNG_CHAIN_FIT_GATED and cap is not None and peak_bytes is not None \
            and peak_bytes > cap:
        _log(f"{rung}: no chained window: the step's measured peak {peak_bytes / 1e9:.1f} GB exceeds the "
             f"card's {cap / 1e9:.0f} GB (fit gate)")
        chain = 0
    chain_time = None
    if chain > 1:
        keys_c = [threefry.fold_in(threefry.prng_key(5, dev), j) for j in range(chain)]
        t0 = time.perf_counter()
        with Heartbeat(rung, "chain-timed", gauges=None):
            th, dl = theta, delta
            for j in range(chain):
                th, dl, mc, _ = step(th, dl, ids, keys_c[j])
            float(mc["opt_score_mean"])  # one read-back, after every chained step
        chain_time = (time.perf_counter() - t0) / chain
        _log(f"{rung}: chained per-step {chain_time:.4f}s vs single-dispatch {step_time:.4f}s")

    headline_time = chain_time if chain_time is not None else step_time
    peak = device_peak_flops(dev)
    mfu_val = step_flops / (headline_time * peak) if step_flops and peak else None
    floor_flops = step_flops or analytic_floor_flops(
        frozen_tensors(backend, reward) + _tree_tensors(theta), imgs_per_step)
    for label, tval in (("chained", chain_time), ("single-dispatch", step_time)):
        if tval is not None:
            err = physical_floor_check(tval, floor_flops, peak, 1)
            if err:
                raise RuntimeError(f"{label}: {err}")
    rf = roofline(step_flops, step_bytes, headline_time, peak_flops=peak, hbm_bw=device_hbm_bandwidth(dev))
    geometry = {"scale": scale, "pop": pop, "m": num_unique, "r": 1, "member_batch": member_batch, **opt,
                "n_processes": n_proc}
    stats = types.SimpleNamespace(**{k: totals[k] for k in ("warmup_s", "capture_s", "instantiate_s", "pool_bytes")})
    record_program(site="bench", label=rung, stats=stats, cost={"flops": step_flops, "bytes_accessed": step_bytes},
                   device=dev, geometry=geometry, extra={"rung": rung, "imgs_per_step": imgs_per_step})
    rec = {
        "rung": rung,
        "geometry": scale,
        "imgs_per_sec": round(imgs_per_step / headline_time, 4),
        "pop": pop,
        "prompts": num_unique,
        "member_batch": member_batch,
        "remat": "none",
        "reward_tile": opt["reward_tile"],
        "noise_dtype": opt["noise_dtype"],
        "tower_dtype": opt["tower_dtype"],
        "pop_fuse": opt["pop_fuse"],
        "base_quant": opt["base_quant"],
        "steps_timed": steps,
        "step_time_s": round(headline_time, 4),
        "step_time_single_dispatch_s": round(step_time, 4),
        "chain": chain if chain_time is not None else 0,
        "dispatch_tax_s": round(step_time - chain_time, 4) if chain_time is not None else None,
        "physical_floor_s": round(floor_flops / peak, 6) if peak else None,
        "mfu": round(mfu_val, 6) if mfu_val is not None else None,
        "step_tflops": round(step_flops / 1e12, 4) if step_flops else None,
        "bytes_accessed": step_bytes,
        "peak_bytes_est": peak_bytes,
        "peak_bytes_source": "max_memory_allocated + graph pool" if peak_bytes is not None else None,
        "lowering_s": None,
        "stablehlo_lines": None,
        "stablehlo_bytes": None,
        "stablehlo_sha256": None,
        "roofline_bound": rf["bound"],
        "predicted_step_time_s": round(rf["t_roofline_s"], 6) if rf["t_roofline_s"] else None,
        "collective_bytes": None,
        "collective_ops": None,
        "t_comms_s": None,
        "opt_scores_digest": opt_scores_digest,
        "opt_scores": [float(s) for s in opt_scores],
        "compile_s": round(compile_s, 2),
        "warmup_s": round(totals["warmup_s"], 3),
        "capture_s": round(totals["capture_s"], 3),
        "instantiate_s": round(totals["instantiate_s"], 3),
        "graph_pool_bytes": totals["pool_bytes"],
        "graphed": bool(cache.graphed),
        "warmup_step_s": round(warm_s, 3),
        "build_s": round(build_s, 2),
        "n_devices": n_proc,
        "cards": torch.cuda.device_count() if cuda else 0,
        "platform": "gpu" if cuda else dev.type,
        "device_kind": device_kind(dev),
        "peak_flops_known": peak is not None,
        "compile_cache_entries": None,
        "compile_cache_dir": None,
        "kernel_launches": launches,
        "profile_dir": profile_dir,
        "opt_score_mean": score,
        "sync": "read-back",
        **artifact_stamp(),
        "mesh_shape": {"pop": n_proc, "data": 1} if n_proc > 1 else None,
    }
    if scale in VAR_SCALES:
        try:
            with Heartbeat(rung, "parity"):
                parity = kernel_parity(backend, rung, dev) or {}
            rec.update({f"kernel_parity_{k}": parity.get(k) for k in ("maxdiff", "rel", "ref_abs")})
        except Exception as e:
            rec["kernel_parity_maxdiff"] = f"error: {type(e).__name__}: {e}"[:200]
    del step, cache, backend, reward, theta, delta, metrics
    _free(dev)
    return rec


def _free(dev: Any) -> None:
    import gc

    import torch

    gc.collect()  # the step's closures keep a backend alive in cycles
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _install_bench_ledger() -> None:
    """Every rung's program record lands in ``BENCH_PROGRAMS_JSONL``
    (default ``bench_runs/programs.jsonl``). The parent never builds a
    program, so it installs none."""
    from ..obs.program_cost import ProgramLedger, set_ledger

    set_ledger(ProgramLedger(os.environ.get("BENCH_PROGRAMS_JSONL", "bench_runs/programs.jsonl")))


def ladder_child(rungs: List[str], deadline_monotonic_s: float, parent: int) -> int:
    """The ladder's child of process ``parent``: resolve the device once,
    then run the rungs in order, one JSON line per rung on stdout as each
    ends."""
    die_with_parent(parent)
    _install_bench_ledger()
    _log(f"child start; rungs={rungs}")
    try:
        import torch

        dev = _device()
        if dev.type == "cuda":
            torch.zeros(1, device=dev)  # the context's first init
    except Exception as e:
        _log(f"device init failed: {type(e).__name__}: {e}")
        for rung in rungs:
            print(json.dumps({"rung": rung, "error": f"{type(e).__name__}: {e}"[:500]}), flush=True)
        return 1
    _log(f"device up: {dev}")
    emit_heartbeat("_startup", "backend_up")
    rc = 0
    for rung in rungs:
        remaining = deadline_monotonic_s - time.monotonic()
        est = RUNG_EST_S.get(rung, 120)
        if remaining < est:
            print(json.dumps({"rung": rung, "error": f"skipped: insufficient budget ({remaining:.0f}s left < est "
                                                     f"{est}s)"}), flush=True)
            continue
        try:
            print(json.dumps(run_rung(rung, dev, allow_env_overrides=False)), flush=True)
        except Exception as e:  # one bad rung must not end the ladder
            _log(f"{rung}: FAILED {type(e).__name__}: {e}")
            print(json.dumps({"rung": rung, "error": f"{type(e).__name__}: {e}"[:500]}), flush=True)
            _free(dev)
            rc = 1
    return rc


# ---------------------------------------------------------------------------
# scaling mode: one rung at 1, 2, 4 processes (a launch_local launch each)
# ---------------------------------------------------------------------------

def scaling_summary(rows: Dict[str, Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Summary over ``{str(processes): rung_record}``: images/s per process,
    efficiency against the 1-process row, and the collective share of the
    step (null: the port counts no collective bytes)."""
    base = rows.get("1") or {}
    base_per_chip = base.get("imgs_per_sec")
    out = []
    for n_str in sorted(rows, key=int):
        r = rows[n_str]
        n = int(n_str)
        ips = r.get("imgs_per_sec")
        per_chip = ips / n if ips else None
        eff = per_chip / base_per_chip if per_chip and base_per_chip else None
        t_comms, st = r.get("t_comms_s"), r.get("step_time_s")
        out.append({
            "devices": n,
            "imgs_per_sec": ips,
            "imgs_per_sec_per_chip": round(per_chip, 4) if per_chip else None,
            "efficiency": round(eff, 4) if eff is not None else None,
            "step_time_s": st,
            "mesh_shape": r.get("mesh_shape"),
            "collective_bytes": r.get("collective_bytes"),
            "collective_ops": r.get("collective_ops"),
            "collective_time_share_est": round(t_comms / st, 4) if t_comms and st else None,
            "opt_scores_digest": r.get("opt_scores_digest"),
            "error": r.get("error"),
        })
    return out


def run_scaling(rung: str, counts: Sequence[int], out_path: Optional[str] = None, device: Optional[str] = None,
                timeout_s: Optional[float] = None) -> int:
    """One ``tools/launch_local.py`` launch of N gloo processes a count,
    each running the rung (its member slice, the host gather of the rows)
    and writing its record; rank 0's is the row. Prints the SCALING
    document (and writes ``out_path``). On one card the N processes share
    it: a parity anchor (``opt_scores_digest`` must agree across counts),
    not a scaling claim."""
    from .launch_local import run_pod

    timeout_s = timeout_s or float(os.environ.get("BENCH_SCALING_TIMEOUT_S",
                                                  str(max(600, RUNG_EST_S.get(rung, 120) * 8))))
    work = Path(os.environ.get("BENCH_SCALING_DIR", "bench_runs/scaling")) / f"{rung}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    rows: Dict[str, Dict[str, Any]] = {}
    for n in counts:
        rec_path = work / f"n{n}_rank{{rank}}.json"
        fwd = ["--rung", rung, "--out", str(rec_path), "--parent", str(os.getpid())] + \
            (["--device", device] if device else [])
        _log(f"scaling[{rung}]: launching {n} process(es)")
        rc = run_pod(n, fwd, timeout_s=timeout_s, entry=("-m", MODULE, "--scaling_child"))
        first = Path(str(rec_path).format(rank=0))
        if rc == 0 and first.exists():
            rows[str(n)] = json.loads(first.read_text())
        else:
            rows[str(n)] = {"rung": rung, "error": f"launch rc={rc}, " + ("no record" if not first.exists()
                                                                          else "nonzero exit")}
        got = rows[str(n)]
        _log(f"scaling[{rung}]: {n} process(es) -> "
             + (f"{got['imgs_per_sec']} imgs/sec" if "imgs_per_sec" in got else got.get("error", "?")))
    platform = next((r.get("platform") for r in rows.values() if r.get("platform")), None)
    cards = next((r.get("cards") for r in rows.values() if r.get("cards")), 0)
    doc = {
        "metric": "scaling-efficiency (imgs scored/sec/process)",
        "rung": rung,
        "device_counts": [int(n) for n in counts],
        "platform_forced": "cpu" if device == "cpu" else None,
        "processes_on_one_card": platform == "gpu" and cards == 1 and max(counts) > 1,
        "rows": rows,
        "summary": scaling_summary(rows),
        **artifact_stamp(),
    }
    line = json.dumps(doc)
    print(line, flush=True)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(line + "\n")
        _log(f"scaling[{rung}]: artifact -> {out_path}")
    return 0 if all("imgs_per_sec" in r for r in rows.values()) else 1


def scaling_child(argv: List[str]) -> int:
    """One process of a scaling launch: join it, run the rung, write the
    record to ``--out`` (``{rank}`` replaced)."""
    import argparse

    ap = argparse.ArgumentParser(prog=f"{MODULE} --scaling_child")
    ap.add_argument("--scaling_child", action="store_true")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--rung", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None)
    ap.add_argument("--parent", type=int, required=True, help="the launching process (the child dies with it)")
    args = ap.parse_args(argv)
    die_with_parent(args.parent)
    import torch

    from ..parallel.mesh import initialize_multihost, process_device

    torch.set_num_threads(1)  # N processes share the host's cores
    initialize_multihost(args.coordinator, args.num_processes, args.process_id)
    rec = run_rung(args.rung, process_device(args.device), allow_env_overrides=False)
    out = Path(args.out.format(rank=args.process_id))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec) + "\n")
    return 0


def scaling_main(argv: List[str], device: Optional[str] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog=f"{MODULE} --scaling",
                                 description="one rung at 1→N processes (a launch_local launch each)")
    ap.add_argument("--scaling", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rungs", "--rung", dest="rung", default="tiny", help="the ONE rung to scale (default: tiny)")
    ap.add_argument("--devices", default=",".join(map(str, SCALING_DEVICE_COUNTS)),
                    help="comma list of process counts, from 1 (default: "
                         f"{','.join(map(str, SCALING_DEVICE_COUNTS))})")
    ap.add_argument("--out", default=None, help="also write the SCALING document to this path")
    args = ap.parse_args(argv)
    rung_list = [r.strip() for r in args.rung.split(",") if r.strip()]
    if len(rung_list) != 1:
        print(f"--scaling runs exactly one rung, got {rung_list!r} "
              "(run once per rung; each produces its own SCALING artifact)", file=sys.stderr)
        return 2
    rung = rung_list[0]
    if rung not in RUNG_PLAN:
        print(f"unknown rung {rung!r} (have: {sorted(RUNG_PLAN)})", file=sys.stderr)
        return 2
    try:
        counts = [int(c) for c in args.devices.split(",") if c.strip()]
    except ValueError:
        counts = []
    if not counts or sorted(set(counts)) != counts or counts[0] != 1:
        print("--devices must be a strictly increasing integer list starting "
              "at 1 (the 1-process row is the efficiency baseline)", file=sys.stderr)
        return 2
    return run_scaling(rung, counts, out_path=args.out, device=device)


# ---------------------------------------------------------------------------
# serve mode: adapter-batched against sequential serving on one rung
# ---------------------------------------------------------------------------

def run_serve_bench(rung: str, adapters: int = 0, images: int = 0, batches: int = 3, metrics_port: int = 0,
                    metrics_host: str = "0.0.0.0", device: Any = None) -> Dict[str, Any]:
    """Adapter-batched against sequential serving throughput, three modes
    over one generator-only backend (``sana_backend.build_serve_backend``:
    no towers) and the same N distinct adapters, interleaved per timed round
    so host jitter taxes each mode alike:

    - ``batched``: ``ServeEngine`` at ``adapter_batch=N``, N requests a
      dispatch (one CUDA graph replay);
    - ``sequential per-adapter`` (the headline denominator): the naive
      composition, one eager ``backend.generate`` a request with its adapter
      staged from the host a request;
    - ``sequential AOT``: the engine's one-slot program (``adapter_batch``
      1), the ablation that separates batching from the program.

    Every timed path reads its images back. The parity round sends the same
    requests through all three; the record has the largest difference and
    whether all are bitwise equal, and a hot-swap probe (one prompt and seed
    for every tenant: images may differ only through the adapter)."""
    import numpy as np
    import torch

    from ..backends.sana_backend import build_serve_backend
    from ..obs.metrics import get_registry
    from ..rungs import sana_rung_model
    from ..serve import ServeConfig, ServeEngine
    from ..utils import threefry
    from ..utils.mfu import device_kind
    from ..utils.pytree import tree_map

    dev = _device(device)
    scale = RUNG_PLAN[rung][0]
    plan = SERVE_PLAN.get(rung, {})
    N = adapters or int(plan.get("adapter_batch", 4))
    B = images or int(plan.get("images_per_request", 1))
    member_batch = int(plan.get("member_batch", 0))
    opt = rung_opt(rung)
    _log(f"serve[{rung}]: building the generator (scale={scale} adapters={N} images={B} "
         f"base={opt['base_quant']}) on {dev}")
    t0 = time.perf_counter()
    with Heartbeat(f"serve:{rung}", "build"):
        backend = build_serve_backend(sana_rung_model(scale)["bcfg"], opt["base_quant"], dev)
    build_s = time.perf_counter() - t0

    # N distinct tenants: LoRA init has b = 0, so every leaf gets a small
    # random perturbation (distinct tenants must give distinct images)
    template = backend.init_theta(threefry.prng_key(0, "cpu"))
    thetas = []
    for i in range(N):
        base = backend.init_theta(threefry.fold_in(threefry.prng_key(8, "cpu"), i))
        leaf_key = threefry.fold_in(threefry.prng_key(7, "cpu"), i)
        order = {(k, f): n for n, (k, f) in enumerate((k, f) for k, d in base.items() for f in d)}
        thetas.append({k: {f: t + 0.05 * threefry.normal(threefry.fold_in(leaf_key, order[(k, f)]),
                                                         tuple(t.shape)).to(t.dtype)
                           for f, t in d.items()} for k, d in base.items()})
    cfg = dict(images_per_request=B, metrics_host=metrics_host, device=dev)
    eng_b = ServeEngine(backend, ServeConfig(adapter_batch=N, member_batch=member_batch, metrics_port=metrics_port,
                                             **cfg), theta_template=template)
    if eng_b.exporter is not None:
        _log(f"serve[{rung}]: live /metrics + /healthz on port {eng_b.exporter.port}")
    eng_s = ServeEngine(backend, ServeConfig(adapter_batch=1, **cfg), theta_template=template)
    for i, th in enumerate(thetas):
        eng_b.put_adapter(f"tenant{i}", th)
        eng_s.put_adapter(f"tenant{i}", th)
    M = backend.num_items

    def prompts(i):
        return [(i + j) % M for j in range(B)]

    def submit_round(eng, r):
        for i in range(N):
            eng.submit(f"tenant{i}", prompts(i), seed=1000 * r + i)

    def naive_request(i, seed):
        # the adapter staged from the host for this request, one eager call
        out = backend.generate(thetas[i], prompts(i), threefry.prng_key(seed, dev))
        return out.to(torch.float32).cpu().numpy()

    # the serving program body's runs at trace time (a warm-up and a capture
    # a program on the card, its first call on the CPU)
    traces0 = get_registry().value("serve_traces", 0)
    _log(f"serve[{rung}]: warming all three paths")
    with Heartbeat(f"serve:{rung}", "compile"), torch.inference_mode():
        eng_b.warmup()
        eng_s.warmup()
        naive_request(0, 0)
        submit_round(eng_b, 0)
        batched = {r.request.adapter_id: r.images for r in eng_b.flush()}
        seq = {f"tenant{i}": eng_s.generate(f"tenant{i}", prompts(i), seed=i) for i in range(N)}
        naive = {f"tenant{i}": naive_request(i, i) for i in range(N)}
    diffs = [float(np.max(np.abs(np.asarray(batched[a], np.float32) - np.asarray(ref[a], np.float32))))
             for ref in (seq, naive) for a in ref]
    parity_bitwise = all(np.array_equal(batched[a], ref[a]) for ref in (seq, naive) for a in ref)
    for i in range(N):
        eng_b.submit(f"tenant{i}", [0] * B, seed=424242)
    probe = {r.request.adapter_id: r.images for r in eng_b.flush()}
    hot_swap = any(not np.array_equal(probe["tenant0"], probe[f"tenant{i}"]) for i in range(1, N))

    _log(f"serve[{rung}]: timing {batches} interleaved rounds (batched / naive / one-slot)")
    dt_b = dt_s = dt_sa = 0.0
    with Heartbeat(f"serve:{rung}", "timed", gauges=None), torch.inference_mode():
        for r in range(1, batches + 1):
            t0 = time.perf_counter()
            submit_round(eng_b, r)
            eng_b.flush()  # the images come back to the host inside
            dt_b += time.perf_counter() - t0
            t0 = time.perf_counter()
            for i in range(N):
                naive_request(i, 1000 * r + i)
            dt_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            for i in range(N):
                eng_s.generate(f"tenant{i}", prompts(i), seed=1000 * r + i)
            dt_sa += time.perf_counter() - t0
    batched_ips, seq_ips, seq_aot_ips = (N * B * batches / dt for dt in (dt_b, dt_s, dt_sa))
    stats_b, stats_s = eng_b.stats(), eng_s.stats()
    rec = {
        "metric": "serve throughput (imgs/sec, adapter-batched vs sequential)",
        "mode": "serve",
        "rung": rung,
        "geometry": scale,
        "adapters": N,
        "images_per_request": B,
        "member_batch": member_batch,
        "batches_timed": batches,
        "batched_imgs_per_sec": round(batched_ips, 4),
        "sequential_imgs_per_sec": round(seq_ips, 4),
        "batched_vs_sequential": round(batched_ips / seq_ips, 4),
        "sequential_aot_imgs_per_sec": round(seq_aot_ips, 4),
        "batched_vs_sequential_aot": round(batched_ips / seq_aot_ips, 4),
        "batched_dispatch_s": round(dt_b / batches, 4),
        "sequential_request_s": round(dt_s / (batches * N), 4),
        "sequential_aot_request_s": round(dt_sa / (batches * N), 4),
        "parity_bitwise": bool(parity_bitwise),
        "parity_max_abs_diff": max(diffs),
        "hot_swap_effective": bool(hot_swap),
        "programs": {**stats_b["programs"], **{f"one_slot:{k}": v for k, v in stats_s["programs"].items()}},
        "hbm_budget_bytes": stats_b["hbm_budget_bytes"],
        "adapter_store": {"resident": stats_b["store"]["resident"],
                          "resident_bytes": stats_b["store"]["resident_bytes"]},
        "serve_compiles": stats_b.get("serve_compiles"),
        "serve_traces": get_registry().value("serve_traces", 0) - traces0,
        "serve_dispatches": stats_b.get("serve_dispatches"),
        "build_s": round(build_s, 2),
        "n_devices": 1,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "device_kind": device_kind(dev),
        "base_quant": opt["base_quant"],
        "sync": "read-back",
        **artifact_stamp(),
    }
    eng_b.close()
    eng_s.close()
    del eng_b, eng_s, backend
    _free(dev)
    return rec


def serve_bench_main(argv: List[str], device: Optional[str] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog=f"{MODULE} --serve",
                                 description="serving bench: adapter-batched vs sequential imgs/sec on one rung")
    ap.add_argument("--serve", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rung", default="tiny", help="the rung geometry to serve (default: tiny)")
    ap.add_argument("--adapters", type=int, default=0, help="distinct adapters / batched width (default: SERVE_PLAN)")
    ap.add_argument("--images", type=int, default=0, help="images per request (default: SERVE_PLAN)")
    ap.add_argument("--batches", type=int, default=3, help="timed rounds per path (default 3)")
    ap.add_argument("--metrics_port", type=int, default=0,
                    help="serve /metrics + /healthz from the batched engine on this port while the bench runs "
                         "(0 = off)")
    ap.add_argument("--metrics_host", default="0.0.0.0", help="exporter bind address (127.0.0.1: loopback only)")
    ap.add_argument("--metrics_linger_s", type=float, default=0.0,
                    help="keep the exporter up this many seconds after the bench finishes")
    ap.add_argument("--out", default=None, help="also write the SERVE document to this path")
    args = ap.parse_args(argv)
    if args.rung not in RUNG_PLAN or RUNG_PLAN[args.rung][0] in VAR_SCALES + INFINITY_SCALES + ("flagship_gen",):
        print(f"unknown or unservable rung {args.rung!r} (the Sana rungs: "
              f"{sorted(r for r in SERVE_PLAN)})", file=sys.stderr)
        return 2
    rec = run_serve_bench(args.rung, args.adapters, args.images, args.batches, metrics_port=args.metrics_port,
                          metrics_host=args.metrics_host, device=device)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
        _log(f"serve[{args.rung}]: artifact -> {args.out}")
    if args.metrics_port and args.metrics_linger_s > 0:
        _log(f"serve: /metrics draining for {args.metrics_linger_s:g}s")
        time.sleep(args.metrics_linger_s)
    return 0


# ---------------------------------------------------------------------------
# fleet mode: one W-job program against the same jobs stepped one by one
# ---------------------------------------------------------------------------

def run_fleet_bench(rung: str, widths: Sequence[int], batches: int = 3, base_quant: Optional[str] = None,
                    device: Any = None) -> Dict[str, Any]:
    """The fleet step (``train.trainer.make_fleet_step``: W distinct jobs,
    each with its own σ, lr scale and seed, one CUDA graph) against the same
    W jobs stepped one after another through their solo programs, in
    interleaved rounds (fused, then sequential), each ending in a read-back
    of the full metrics. Per width: images/s of each, their ratio, the
    fused program's counted bytes per job, and each job's epoch-0 reward
    rows' sha256 in the fleet program and in the solo step's front half
    (``train.fleet.make_solo_reward_rows``), with ``parity_bitwise``.

    What the ratio can show: the host round trips one program saves over W
    dispatches and W read-backs. What it cannot: device work shared across
    jobs. The port's fleet program runs the W jobs' populations one after
    another inside the graph (queue C in ROADMAP: lanes spanning jobs need
    K2 and K3 with a per-lane ``w``), so its device time is W solo epochs'
    and the ratio stays near 1 wherever the epoch is device-bound."""
    import numpy as np
    import torch

    from ..lora import stack_adapters
    from ..train.config import TrainConfig
    from ..train.fleet import make_solo_reward_rows, reward_rows_digest
    from ..train.trainer import device_ids, fleet_scalar_args, make_es_step, make_fleet_step, program_cache
    from ..utils import threefry
    from ..utils.mfu import device_kind
    from ..utils.pytree import tree_map

    dev = _device(device)
    scale, pop, m, member_batch = RUNG_PLAN[rung]
    pop = int(os.environ.get("BENCH_POP", pop))
    m = int(os.environ.get("BENCH_PROMPTS", m))
    opt = rung_opt(rung)
    if base_quant is not None:
        opt["base_quant"] = base_quant
    _log(f"fleet[{rung}]: building (scale={scale} pop={pop} m={m} base={opt['base_quant']}) on {dev}")
    t0 = time.perf_counter()
    with Heartbeat(f"fleet:{rung}", "build"):
        if scale in VAR_SCALES + INFINITY_SCALES:
            raise ValueError(f"--fleet runs the Sana rungs; {rung!r} is a {scale} plan")
        from ..backends.sana_backend import build_train_backend

        backend, reward = build_train_backend(scale, dev, base_quant=opt["base_quant"], seed=0)
    build_s = time.perf_counter() - t0

    def job_tc(j):
        # distinct hyperparameters a job, the cohort's geometry shared; the
        # factored member path on both sides
        return TrainConfig(pop_size=pop, sigma=0.01 * (1.0 + 0.5 * j), lr_scale=1.0 + 0.25 * j, egg_rank=4,
                           prompts_per_gen=m, batches_per_gen=1, member_batch=member_batch, promptnorm=True,
                           reward_tile=opt["reward_tile"], noise_dtype=opt["noise_dtype"],
                           tower_dtype=opt["tower_dtype"], pop_fuse=True, base_quant=opt["base_quant"],
                           quality=False, seed=11 + j)

    num_unique = min(m, backend.num_items)
    ids = device_ids(backend.step_info(0, num_unique, 1).flat_ids, dev)
    max_j = max(widths)
    tcs = [job_tc(j) for j in range(max_j)]
    thetas = [backend.init_theta(threefry.fold_in(threefry.prng_key(t.seed, "cpu"), 17)) for t in tcs]
    keys = [threefry.fold_in(threefry.prng_key(t.seed, dev), 0) for t in tcs]

    def fresh(th):
        th = tree_map(lambda t: t.to(dev), th)
        return th, tree_map(torch.zeros_like, th)

    _log(f"fleet[{rung}]: {max_j} solo programs and their reward rows")
    solo_steps, solo_digests = [], []
    with Heartbeat(f"fleet:{rung}", "solo-compile"):
        for j, t in enumerate(tcs):
            solo_steps.append(make_es_step(backend, reward, t, num_unique, 1, dev, stateful_delta=True,
                                           graphs=program_cache(backend, dev)))
            out = solo_steps[j](*fresh(thetas[j]), ids, keys[j])
            float(out[2]["opt_score_mean"])  # warm-up and capture
            rows = make_solo_reward_rows(backend, reward, t)(tree_map(lambda x: x.to(dev), thetas[j]), ids, keys[j])
            solo_digests.append(reward_rows_digest(rows))

    rows_out, solo_bytes, traces = [], None, 0
    for J in widths:
        jt = tcs[:J]
        sig, csc, lrs = (torch.from_numpy(x).to(dev) for x in fleet_scalar_args(jt))
        keys_j = torch.stack(keys[:J])
        ids_j = ids.expand(J, -1).contiguous()
        cache = program_cache(backend, dev, count_cost=True)
        fleet = make_fleet_step(backend, reward, jt[0], num_unique, 1, J, dev, graphs=cache)

        def fused_args():
            st = tree_map(lambda t: t.to(dev), stack_adapters(thetas[:J]))
            return st, tree_map(torch.zeros_like, st), ids_j, keys_j, sig, csc, lrs

        t_c0 = time.perf_counter()
        with Heartbeat(f"fleet:{rung}", f"compile-j{J}"):
            _, _, metrics_f, _ = fleet(*fused_args())
            fleet_rows = metrics_f["fleet_reward_rows"].to("cpu", torch.float32).numpy()
        compile_s = time.perf_counter() - t_c0
        fleet_digests = [reward_rows_digest(fleet_rows[j]) for j in range(J)]
        parity = all(fleet_digests[j] == solo_digests[j] for j in range(J))

        _log(f"fleet[{rung}]: J={J} timing {batches} interleaved rounds")
        dt_f = dt_s = 0.0
        with Heartbeat(f"fleet:{rung}", f"timed-j{J}", gauges=None):
            for _ in range(batches):
                a = fused_args()
                t0 = time.perf_counter()
                _, _, mf, _ = fleet(*a)
                {k: v.cpu() for k, v in mf.items()}  # the scheduler's one read-back a tick
                dt_f += time.perf_counter() - t0
                sargs = [fresh(thetas[j]) for j in range(J)]
                t0 = time.perf_counter()
                for j in range(J):
                    _, _, ms, _ = solo_steps[j](*sargs[j], ids, keys[j])
                    {k: v.cpu() for k, v in ms.items()}  # run_training's read-back an epoch
                dt_s += time.perf_counter() - t0
        imgs = J * pop * num_unique * batches
        fused_ips, seq_ips = imgs / dt_f, imgs / dt_s
        entry = cache.entries[("fleet", J, num_unique, 1)]
        fused_bytes = (entry.cost or {}).get("bytes_accessed")
        if J == 1:
            solo_bytes = fused_bytes
        traces += fleet.traces
        rows_out.append({
            "width": J,
            "fused_imgs_per_sec_chip": round(fused_ips, 4),
            "sequential_imgs_per_sec_chip": round(seq_ips, 4),
            "fused_vs_sequential": round(fused_ips / seq_ips, 4),
            "fused_step_s": round(dt_f / batches, 4),
            "sequential_step_s": round(dt_s / batches, 4),
            "bytes_accessed": fused_bytes,
            "bytes_per_job": round(fused_bytes / J) if fused_bytes else None,
            "peak_bytes_est": None,
            "graph_pool_bytes": entry.stats.pool_bytes,
            "stablehlo_sha256": None,
            "compile_s": round(compile_s, 2),
            "reward_rows_sha256": fleet_digests,
            "solo_rows_sha256": solo_digests[:J],
            "parity_bitwise": bool(parity),
        })
        del fleet, cache, metrics_f
    rec = {
        "metric": "fleet training throughput (imgs/sec/chip, fused J-job step vs J sequential single-job steps)",
        "mode": "fleet",
        "rung": rung,
        "geometry": scale,
        "pop": pop,
        "prompts": num_unique,
        "member_batch": member_batch,
        "pop_fuse": True,
        "batches_timed": batches,
        "widths": rows_out,
        # Python runs of the fleet programs' bodies: a warm-up and a capture
        # a program on the card, every call on the CPU
        "fleet_traces": traces,
        "widths_compiled": len(widths),
        "solo_bytes_accessed": solo_bytes,
        "parity_bitwise": all(r["parity_bitwise"] for r in rows_out),
        "build_s": round(build_s, 2),
        "n_devices": 1,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "device_kind": device_kind(dev),
        "base_quant": opt["base_quant"],
        "sync": "read-back",
        **artifact_stamp(),
    }
    del solo_steps, backend, reward
    _free(dev)
    return rec


def fleet_bench_main(argv: List[str], device: Optional[str] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog=f"{MODULE} --fleet",
                                 description="fleet bench: fused J-job ES step vs J sequential single-job steps")
    ap.add_argument("--fleet", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rung", default="tiny", help="the rung geometry to fleet-train (default: tiny)")
    ap.add_argument("--widths", default="1,2,4", help="comma list of fleet widths J (default: 1,2,4)")
    ap.add_argument("--batches", type=int, default=3, help="timed rounds per width (default 3)")
    ap.add_argument("--base", default="int8", choices=["off", "int8"],
                    help="frozen-base storage (default int8, the resident base a fleet shares)")
    ap.add_argument("--out", default=None, help="also write the FLEET document to this path")
    args = ap.parse_args(argv)
    if args.rung not in RUNG_PLAN:
        print(f"unknown rung {args.rung!r} (have: {sorted(RUNG_PLAN)})", file=sys.stderr)
        return 2
    try:
        widths = [int(w) for w in args.widths.split(",") if w.strip()]
    except ValueError:
        widths = []
    if not widths or any(w < 1 for w in widths):
        print(f"bad --widths {args.widths!r}", file=sys.stderr)
        return 2
    rec = run_fleet_bench(args.rung, widths, args.batches, base_quant=args.base, device=device)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
        _log(f"fleet[{args.rung}]: artifact -> {args.out}")
    return 0


# ---------------------------------------------------------------------------
# parent: budget and stall caps over a streaming child (no torch here)
# ---------------------------------------------------------------------------

def _child_argv(rungs: List[str]) -> List[str]:
    """The ladder child's command line."""
    return [sys.executable, "-m", MODULE, "--child", ",".join(rungs), "--parent", str(os.getpid())]


INIT_SILENCE_S = 240.0  # a child silent this long (at most half the budget) is an error


def rung_stall_cap(left_s: float, n_pending: int) -> float:
    """A rung's stall cap, the JAX runner's rule: its share of the time
    left, at least 240 s (a phase of a flagship build can sit minutes in
    one heartbeat phase)."""
    return max(240.0, left_s / max(n_pending, 1))


class _ChildReader:
    """Streams a ladder child: rung lines on its stdout, heartbeats on its
    stderr (forwarded verbatim to ours, so a stall stays diagnosable)."""

    def __init__(self, rungs: List[str], deadline: float):
        env = dict(os.environ)
        env.pop("BENCH_POP", None)  # a direct --rung's overrides must not rescale the ladder
        env.pop("BENCH_PROMPTS", None)
        env["BENCH_DEADLINE_IN_S"] = str(max(10.0, deadline - time.monotonic()))
        self.proc = subprocess.Popen(_child_argv(rungs), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                     env=env, cwd=REPO)
        self.lines: list = []
        self._t = threading.Thread(target=self._pump, daemon=True)
        self._t_err = threading.Thread(target=self._pump_err, daemon=True)
        self._t.start()
        self._t_err.start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            line = line.strip()
            if line.startswith("{"):
                try:
                    self.lines.append(json.loads(line))
                except json.JSONDecodeError:
                    pass

    def _pump_err(self) -> None:
        for raw in self.proc.stderr:
            line = raw.strip()
            if line.startswith("{"):
                try:
                    item = json.loads(line)
                except json.JSONDecodeError:
                    item = None
                if isinstance(item, dict) and "hb" in item:  # only heartbeats are liveness
                    self.lines.append(item)
            sys.stderr.write(raw)
            sys.stderr.flush()

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        # a rung line may still sit in the pipe: join before the caller reads
        self._t.join(timeout=5)
        self._t_err.join(timeout=5)


def _final(results: Dict[str, Dict[str, Any]], **fields: Any) -> Dict[str, Any]:
    return {"metric": "population-evals/sec (imgs scored/sec)", "value": None, "unit": "imgs/sec",
            "vs_baseline": None, **fields, "platform_fallback": None, **artifact_stamp(), "rungs": results}


def main() -> int:
    """The ladder: spawn the child, keep the budget and stall caps, print
    one JSON line; 0 when a rung completed and none is impossible."""
    budget = float(os.environ.get("BENCH_BUDGET_S", "540"))
    deadline = time.monotonic() + budget - 15  # reporting reserve
    if os.environ.get("BENCH_TINY") == "1":
        rungs = ["tiny"]
    else:
        rungs = [r.strip() for r in os.environ.get("BENCH_RUNGS", ",".join(RUNG_ORDER)).split(",") if r.strip()]
    unknown = [r for r in rungs if r not in RUNG_PLAN]
    if unknown:
        print(f"unknown rungs {unknown} (have: {sorted(RUNG_PLAN)})", file=sys.stderr)
        return 2
    silence_s = min(INIT_SILENCE_S, budget / 2)
    results = {r: {"rung": r, "error": "no result (budget exhausted)"} for r in rungs}
    pending = list(rungs)
    came_up = [False]
    silent = None
    attempts = 0
    while pending and time.monotonic() < deadline - 30 and attempts < 3 and silent is None:
        attempts += 1
        _log(f"spawning ladder child (attempt {attempts}) for {pending}")
        reader = _ChildReader(pending, deadline)
        consumed = [0]
        last_hb = [None]

        def drain() -> bool:
            """Fold new lines in; True on progress (a rung line, or a
            heartbeat of another (rung, phase) than the last one)."""
            progress = False
            while len(reader.lines) > consumed[0]:
                item = reader.lines[consumed[0]]
                consumed[0] += 1
                came_up[0] = True
                if "hb" in item:
                    state = (item.get("hb"), item.get("phase"))
                    if state != last_hb[0]:
                        last_hb[0] = state
                        progress = True
                    continue
                progress = True
                rung = item.get("rung")
                if rung in results:
                    results[rung] = item
                    if rung in pending:
                        pending.remove(rung)
                _log(f"rung {rung}: {'ok' if 'imgs_per_sec' in item else item.get('error', '?')}")
            return progress

        wait_start = time.monotonic()
        got_line = False
        stalled = None
        while pending:
            now = time.monotonic()
            if drain():
                got_line = True
                wait_start = now
                continue
            if now >= deadline:
                _log("global deadline reached; killing child")
                break
            if reader.proc.poll() is not None:
                reader._t.join(timeout=5)
                drain()
                _log(f"child exited rc={reader.proc.returncode}; {len(pending)} rungs unreported")
                if not got_line:
                    silent = f"the ladder child exited rc={reader.proc.returncode} without a line"
                break
            if got_line:
                cap = rung_stall_cap(deadline - wait_start, len(pending))
                if now - wait_start > cap:
                    stalled = pending[0]
                    _log(f"rung {stalled} stalled (> {cap:.0f}s); killing child, will retry the rest")
                    break
            elif now - wait_start > silence_s:
                # no CPU fallback: a silent child is an error
                silent = f"the ladder child printed nothing for {silence_s:.0f}s (device init never returned?)"
                _log(silent + "; killing it")
                break
            time.sleep(0.2)
        reader.kill()
        drain()
        if stalled is not None and stalled in pending:
            results[stalled] = {"rung": stalled, "error": "stalled: no result within per-rung cap"}
            pending.remove(stalled)

    ok = [r for r in results.values() if "imgs_per_sec" in r]
    if not ok:
        err = "no rung completed"
        if attempts == 0:
            err += " (budget too small to spawn a ladder child)"
        elif silent is not None:
            err += f" ({silent})"
        print(json.dumps(_final(results, error=err, backend_came_up=came_up[0])))
        return 1
    bad = [r for r in ok if r.get("mfu") is not None and r["mfu"] > 1.0]
    if bad:
        print(json.dumps(_final(results, error="IMPOSSIBLE MFU > 1.0 — timing is not execution-synced: "
                                               f"{[(r['rung'], r['mfu']) for r in bad]}",
                                backend_came_up=came_up[0])))
        return 1
    order = {name: i for i, name in enumerate(HEADLINE_ORDER)}
    head = max(ok, key=lambda r: order.get(r["rung"], -1))
    vs = (round(head["imgs_per_sec"] / BASELINE_IMGS_PER_SEC, 4)
          if head["geometry"] == "flagship" and head.get("platform") == "gpu" else None)
    print(json.dumps({
        "metric": "population-evals/sec (imgs scored/sec)",
        "value": head["imgs_per_sec"],
        "unit": "imgs/sec",
        "vs_baseline": vs,
        "baseline_estimated": True,
        "geometry": head["geometry"],
        "pop": head["pop"],
        "member_batch": head["member_batch"],
        "mfu": head.get("mfu"),
        "mfu_gate_armed": head.get("mfu") is not None,
        "platform": head.get("platform"),
        "platform_fallback": None,
        **artifact_stamp(),
        "rungs": results,
    }))
    return 0


def _take(argv: List[str], flag: str) -> Tuple[List[str], Optional[str]]:
    """``argv`` without ``flag VALUE``/``flag=VALUE``, and the value."""
    argv = list(argv)
    for i, tok in enumerate(argv):
        if tok == flag or tok.startswith(flag + "="):
            if tok == flag:
                if i + 1 >= len(argv):
                    raise SystemExit(f"{flag} needs an argument")
                value = argv[i + 1]
                del argv[i:i + 2]
            else:
                value = tok.split("=", 1)[1]
                del argv[i]
            if not value:
                raise SystemExit(f"{flag} needs an argument")
            return argv, value
    return argv, None


def cli(argv: List[str]) -> int:
    """Dispatch the command line (module note)."""
    argv, cache = _take(argv, "--compile_cache")
    if cache is not None:
        raise SystemExit("--compile_cache is refused: a CUDA graph cannot be serialized, so there is no persistent "
                         "program cache to pin (ROADMAP queue C)")
    argv, profile = _take(argv, "--profile")
    if profile is not None:
        os.makedirs(profile, exist_ok=True)
        os.environ["BENCH_PROFILE_DIR"] = os.path.abspath(profile)
    if "--scaling_child" in argv:
        return scaling_child(argv)
    argv, device = _take(argv, "--device")
    if device is not None:
        os.environ["BENCH_DEVICE"] = device  # the ladder's children read it
    if "--scaling" in argv:
        return scaling_main(argv, device)
    if len(argv) >= 2 and argv[0] == "--child":
        rungs = [r for r in argv[1].split(",") if r]
        _, parent = _take(argv[2:], "--parent")
        if parent is None:
            raise SystemExit("--child needs --parent PID")
        deadline = time.monotonic() + float(os.environ.get("BENCH_DEADLINE_IN_S", "525"))
        return ladder_child(rungs, deadline, int(parent))
    if "--serve" in argv:
        return serve_bench_main(argv, device)
    if "--fleet" in argv:
        return fleet_bench_main(argv, device)
    if len(argv) >= 2 and argv[0] == "--rung":
        _install_bench_ledger()
        print(json.dumps(run_rung(argv[1], device, allow_env_overrides=True)))
        return 0
    if argv:
        print(f"unknown arguments {argv} (module note: --rung R, --serve, --fleet, --scaling, --device, "
              "--profile)", file=sys.stderr)
        return 2
    return main()


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
