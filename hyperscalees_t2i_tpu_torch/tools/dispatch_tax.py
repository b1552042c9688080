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

The JAX tool's ``fleet2`` variant waits for the fleet step (ROADMAP queue A
item 6). On the CPU only ``eager`` and ``chained`` run: there are no graphs.

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
        rec["graphs"] = graphs
    for k, v in list(rec.items()):
        if k.endswith("_s") and isinstance(v, float):
            rec[k] = round(v, 6)
    return rec


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
