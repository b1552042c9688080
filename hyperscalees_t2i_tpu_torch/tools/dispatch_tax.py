"""Dispatch-tax microbench (port of ``hyperscalees_t2i_tpu/tools/dispatch_tax.py``):
one rung's ES epoch step timed as several variants, one JSON row::

    python -m hyperscalees_t2i_tpu_torch.tools.dispatch_tax --rung tiny --device cpu
    python -m hyperscalees_t2i_tpu_torch.tools.dispatch_tax --rung flagship --steps 3 --chain 4

Variants (same geometry, same weights, same keys):

- ``eager``   — the step launched kernel by kernel from Python
  (``graph=False``), its metrics read back after every step: what the
  launch tax is measured against on the card.
- ``single``  — one CUDA graph replay a step, read back after every step
  (``run_training`` with ``steps_per_dispatch=1``).
- ``chained`` — ``--chain`` replays of the same graph with one read-back at
  the end (``steps_per_dispatch``); on the CPU, eager steps with one
  read-back. ``dispatch_tax_s`` = single (eager on the CPU) − chained per
  step: what dropping the per-step read-back saves; ``launch_tax_s`` =
  eager − single.
- ``fused``   — ``single`` with ``pop_fuse=True`` (the factored member
  path).
- ``fused_qlora`` — ``fused`` over an int8 base (K3 at the adapted sites).
- ``fleet2``  — two jobs (the rung's base and the fused path, two keys)
  through one W=2 fleet program (``train.trainer.make_fleet_step``) against
  the same two jobs stepped one after the other through one solo program,
  θ and Δθ chained per job, one read-back at the end of each timed window.
  ``fleet2_amortization`` = sequential s / fused s: what one program for
  two jobs saves over two dispatches.

On the CPU only ``eager``, ``chained`` and ``fleet2`` run, eagerly: there
are no graphs.

Every read-back is of ``opt_score_mean``, which depends on every step
before it (θ and Δθ chain through them), and every timed window ends in
one, so the clock cannot stop at the launch. Weights are random at the rung's geometry. The row carries
the JAX row's fields for the variants run, each graph's capture and
instantiate seconds and pool bytes, the device's name, its power limit
(``nvidia-smi``) and the checkout's git sha.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

REPO = Path(__file__).resolve().parents[2]


def build_rung(rung: str, device: torch.device, base_quant: Optional[str] = None):
    """The rung's backend and reward suite, as ``build_train_backend``
    builds them (``base_quant`` overrides the rung's)."""
    from ..backends.sana_backend import build_train_backend

    return build_train_backend(rung, device=device, base_quant=base_quant, seed=0)


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True, text=True, timeout=30)
    except OSError:
        return None
    return out.stdout.strip() or None if out.returncode == 0 else None


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except OSError:
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run(rung: str, steps: int, chain: int, device: Any = None,
        built: Optional[Tuple[Any, Any]] = None) -> Dict[str, Any]:
    """The row. ``built`` is the rung's ``(backend, reward)`` when the caller
    has them (``chip_smoke.py`` reuses its flagship build)."""
    from ..device import resolve_device
    from ..rungs import RUNG_PLAN, rung_opt
    from ..train.config import TrainConfig
    from ..train.trainer import device_ids, make_es_step
    from ..utils import threefry
    from ..utils.graphs import GraphCache
    from ..utils.pytree import tree_map

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    _, pop, m, member_batch = RUNG_PLAN[rung]
    opt = rung_opt(rung)
    backend, reward = built if built is not None else build_rung(rung, dev)
    num_unique = min(m, backend.num_items)
    ids = device_ids(backend.step_info(0, num_unique, 1).flat_ids, dev)
    theta0 = tree_map(lambda t: t.to(dev), backend.init_theta(threefry.prng_key(1, dev)))
    key = threefry.prng_key(3, dev)

    def make(backend_, reward_, pop_fuse: bool, base_quant: str, graph: bool):
        tc = TrainConfig(pop_size=pop, sigma=0.01, egg_rank=4, prompts_per_gen=num_unique, batches_per_gen=1,
                         member_batch=member_batch, promptnorm=True, reward_tile=opt["reward_tile"],
                         noise_dtype=opt["noise_dtype"], tower_dtype=opt["tower_dtype"], pop_fuse=pop_fuse,
                         base_quant=base_quant)
        return make_es_step(backend_, reward_, tc, num_unique, 1, dev, stateful_delta=True,
                            graphs=GraphCache(dev, graph=graph))

    def fresh(theta=theta0):
        return tree_map(torch.clone, theta), tree_map(torch.zeros_like, theta)

    def timed(step, theta=theta0) -> Tuple[float, Any]:
        """The warm-up call (a graph's capture), then ``steps`` steps, θ and
        Δθ chained, each read back."""
        th, dl = fresh(theta)
        th, dl, metrics, _ = step(th, dl, ids, threefry.fold_in(key, 1000))
        float(metrics["opt_score_mean"])
        t0 = time.perf_counter()
        for e in range(steps):
            th, dl, metrics, _ = step(th, dl, ids, threefry.fold_in(key, e))
            float(metrics["opt_score_mean"])
        return (time.perf_counter() - t0) / steps, step

    rec: Dict[str, Any] = {
        "metric": "dispatch_tax", "rung": rung, "pop": pop, "prompts": num_unique, "member_batch": member_batch,
        "base_quant": opt["base_quant"], "steps_timed": steps, "chain": chain,
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "card": _power_limit() if cuda else None,
        "sync": "read-back", "torch_version": torch.__version__, "git_sha": _git_sha(),
    }
    graphs: Dict[str, Any] = {}
    rec["step_time_eager_s"], single = timed(make(backend, reward, False, opt["base_quant"], graph=False))
    if cuda:
        single = make(backend, reward, False, opt["base_quant"], graph=True)
        rec["step_time_single_s"], _ = timed(single)
    # chained: `chain` steps' ids and keys staged on the device, one read-back
    keys_k = torch.stack([threefry.fold_in(key, 2000 + j) for j in range(chain)])
    ids_k = ids.expand(chain, -1).contiguous()
    th, dl = fresh()
    th, dl, metrics, _ = single(th, dl, ids, threefry.fold_in(key, 1000))
    float(metrics["opt_score_mean"])
    t0 = time.perf_counter()
    for j in range(chain):
        th, dl, metrics, _ = single(th, dl, ids_k[j], keys_k[j])
    float(metrics["opt_score_mean"])
    rec["step_time_chained_s"] = (time.perf_counter() - t0) / chain
    base = rec.get("step_time_single_s", rec["step_time_eager_s"])
    rec["dispatch_tax_s"] = base - rec["step_time_chained_s"]
    if cuda:
        rec["launch_tax_s"] = rec["step_time_eager_s"] - rec["step_time_single_s"]
        graphs["single"] = _stats(single)
        rec["step_time_fused_s"], fused = timed(make(backend, reward, True, opt["base_quant"], graph=True))
        rec["fused_speedup_s"] = rec["step_time_single_s"] - rec["step_time_fused_s"]
        graphs["fused"] = _stats(fused)
        del single, fused
        if opt["base_quant"] == "int8":
            backend_q, reward_q, theta_q = backend, reward, theta0
        else:
            backend_q, reward_q = build_rung(rung, dev, base_quant="int8")
            theta_q = tree_map(lambda t: t.to(dev), backend_q.init_theta(threefry.prng_key(1, dev)))
        rec["step_time_fused_qlora_s"], qlora = timed(make(backend_q, reward_q, True, "int8", graph=True), theta_q)
        graphs["fused_qlora"] = _stats(qlora)
        del qlora
    rec.update(fleet2(backend, reward, theta0, ids, key, num_unique, steps, pop, member_batch, opt, dev, graphs))
    if cuda:
        rec["graphs"] = graphs
    for k, v in list(rec.items()):
        if k.endswith("_s") and isinstance(v, float):
            rec[k] = round(v, 6)
    return rec


def fleet2(backend: Any, reward: Any, theta0: Any, ids: torch.Tensor, key: torch.Tensor, num_unique: int,
           steps: int, pop: int, member_batch: int, opt: Dict[str, Any], dev: torch.device,
           graphs: Dict[str, Any]) -> Dict[str, Any]:
    """The ``fleet2`` fields: two jobs a tick through one W=2 fleet program
    against the same two jobs through one solo program, one after the other
    (the solo program's outputs are its graph's buffers, so each job's θ and
    Δθ are cloned out before the other job replays it)."""
    from ..lora import stack_adapters
    from ..train.config import TrainConfig
    from ..train.trainer import fleet_scalar_args, make_es_step, make_fleet_step
    from ..utils import threefry
    from ..utils.graphs import GraphCache, graphs_on
    from ..utils.pytree import tree_map

    tc = TrainConfig(pop_size=pop, sigma=0.01, egg_rank=4, prompts_per_gen=num_unique, batches_per_gen=1,
                     member_batch=member_batch, promptnorm=True, reward_tile=opt["reward_tile"],
                     noise_dtype=opt["noise_dtype"], tower_dtype=opt["tower_dtype"], pop_fuse=True,
                     base_quant=opt["base_quant"])
    graph = graphs_on(dev)
    fleet = make_fleet_step(backend, reward, tc, num_unique, 1, 2, dev, graphs=GraphCache(dev, graph=graph))
    stacked = stack_adapters([theta0, theta0])
    ids2 = torch.stack([ids, ids])
    rows = tuple(torch.from_numpy(x).to(dev) for x in fleet_scalar_args([tc, tc]))
    jobs = (threefry.prng_key(2, dev), threefry.prng_key(4, dev))
    th, dl, metrics, _ = fleet(tree_map(torch.clone, stacked), tree_map(torch.zeros_like, stacked), ids2,
                               torch.stack([threefry.fold_in(k, 1000) for k in jobs]), *rows)
    float(metrics["opt_score_mean"].sum())  # warm-up (the capture)
    keys_e = [torch.stack([threefry.fold_in(k, e) for k in jobs]) for e in range(steps)]
    t0 = time.perf_counter()
    for e in range(steps):
        th, dl, metrics, _ = fleet(th, dl, ids2, keys_e[e], *rows)
    float(metrics["opt_score_mean"].sum())
    fused_s = (time.perf_counter() - t0) / steps
    if graph:
        graphs["fleet2"] = _stats(fleet)
    del fleet, th, dl, metrics

    solo = make_es_step(backend, reward, tc, num_unique, 1, dev, stateful_delta=True,
                        graphs=GraphCache(dev, graph=graph))
    state = [(tree_map(torch.clone, theta0), tree_map(torch.zeros_like, theta0)) for _ in jobs]

    def advance(j: int, k: torch.Tensor):
        th_j, dl_j, m_j, _ = solo(*state[j], ids, k)
        state[j] = (tree_map(torch.clone, th_j), tree_map(torch.clone, dl_j))
        return m_j["opt_score_mean"].clone()

    for j, k in enumerate(jobs):
        float(advance(j, threefry.fold_in(k, 1000)))  # warm-up (the capture)
    t0 = time.perf_counter()
    for e in range(steps):
        last = [advance(j, keys_e[e][j]) for j in range(len(jobs))]
    float(sum(last))
    seq_s = (time.perf_counter() - t0) / steps
    return {"step_time_fleet2_fused_s": fused_s, "step_time_fleet2_sequential_s": seq_s,
            "fleet2_amortization": round(seq_s / fused_s, 4) if fused_s > 0 else None}


def _stats(step) -> Dict[str, Any]:
    """Capture and instantiate seconds and pool bytes of the step's graph."""
    cache = step.graphs
    return next(iter(cache.stats().values()), {})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rung", default="tiny", help="sana-family rung to time (default: tiny)")
    ap.add_argument("--steps", type=int, default=5, help="timed steps per variant")
    ap.add_argument("--chain", type=int, default=4, help="replays per chained dispatch (min 2)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="also append the JSON row to this file")
    args = ap.parse_args(argv)
    from ..rungs import RUNG_PLAN

    if args.rung not in RUNG_PLAN or args.rung in ("ar_d16", "inf_2b"):
        print(f"unsupported rung {args.rung!r} (sana-family rungs only)", file=sys.stderr)
        return 2
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    line = json.dumps(run(args.rung, args.steps, max(args.chain, 2), args.device))
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
