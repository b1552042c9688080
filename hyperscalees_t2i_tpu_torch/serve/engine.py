"""ServeEngine: multi-tenant LoRA inference over one resident frozen base.

Port of the core of ``hyperscalees_t2i_tpu/serve/engine.py``:

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
  (``serve_compiles``) stays flat;
- a partial batch pads to ``adapter_batch`` lanes with slot 0's adapter,
  prompt ids and key, and drops the padded lanes' images
  (``serve_padded_slots`` counts them), the JAX engine's convention.

The JAX engine's admission gate, overload governor, metrics exporter, SLOs
and profiler are not ported yet.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backends.base import GeneratorBackend
from ..device import DeviceLike, resolve_device
from ..lora import stack_adapters
from ..obs.metrics import MetricsRegistry
from ..parallel.pop_eval import make_adapter_batch_generator
from ..utils import threefry
from ..utils.graphs import GraphCache
from ..utils.pytree import tree_map
from .adapter_store import AdapterStore
from .batcher import RequestQueue, ServeRequest, ServeResult

Adapter = Any


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """``adapter_batch``: lanes per dispatch; ``images_per_request``: the
    default request shape warmed by :meth:`ServeEngine.warmup`;
    ``member_batch``: lanes per chunk inside a dispatch (0 = all);
    ``adapter_budget_bytes``: the store's working set (0 = unbounded);
    ``device``: ``None`` = the CUDA card."""

    adapter_batch: int = 4
    images_per_request: int = 1
    member_batch: int = 0
    adapter_budget_bytes: int = 0
    max_queue: int = 1024
    device: DeviceLike = None


class ServeEngine:
    """Owns the adapter store, the request queue and one batch generator per
    request geometry over a set-up backend."""

    def __init__(
        self,
        backend: GeneratorBackend,
        cfg: Optional[ServeConfig] = None,
        graph: bool = True,
    ):
        self.backend = backend
        self.cfg = cfg or ServeConfig()
        if self.cfg.adapter_batch < 1:
            raise ValueError(f"adapter_batch must be >= 1, got {self.cfg.adapter_batch}")
        self.device = resolve_device(self.cfg.device)
        if backend.device != self.device:
            raise ValueError(f"backend is on {backend.device}, the engine on {self.device}")
        # the adapter structure every tenant must match (identity at init)
        self.template = backend.init_theta(threefry.prng_key(0, self.device))
        self.store = AdapterStore(self.cfg.adapter_budget_bytes, template=self.template)
        self.queue = RequestQueue(self.cfg.max_queue)
        # serve_compiles, serve_padded_slots and the programs gauge, under the JAX names
        self.registry = MetricsRegistry(prefix="")
        # one program per (adapter lanes, images per request, guidance);
        # graph=False runs them eagerly on the card (A/B timing)
        self.programs = GraphCache(self.device, graph=graph, registry=self.registry, counter="serve_compiles",
                                   gauge="serve/programs_resident",
                                   span_attrs=lambda k: {"adapter_batch": k[0], "images_per_request": k[1],
                                                         "guidance": k[2]})
        self._undelivered: List[ServeResult] = []
        self.counters = {"requests": 0, "dispatches": 0, "refused": 0, "images": 0}
        self.dispatch_seconds: List[float] = []

    # -- adapters ------------------------------------------------------------
    def put_adapter(self, adapter_id: str, theta: Adapter) -> str:
        """Register an in-memory adapter; returns its content version."""
        return self.store.put(adapter_id, theta).version

    def _run(self, thetas: Sequence[Adapter], ids: List[List[int]], seeds: List[int],
             guidance: Optional[float]) -> np.ndarray:
        """One dispatch of ``n ≤ adapter_batch`` requests, padded to
        ``adapter_batch`` lanes with slot 0's adapter, ids and seed; the
        padded lanes' images are dropped."""
        n, A = len(thetas), self.cfg.adapter_batch
        lanes = list(range(n)) + [0] * (A - n)
        stacked = tree_map(lambda t: t.to(self.device), stack_adapters([thetas[i] for i in lanes]))
        ids_t = torch.tensor([ids[i] for i in lanes], dtype=torch.long).to(self.device)
        # a request's key is PRNGKey(seed); its image j folds j in (the JAX engine's)
        keys = torch.stack([threefry.prng_key(seeds[i], self.device) for i in lanes])
        B = len(ids[0])
        gen = make_adapter_batch_generator(self.backend.generate_p, A, B, member_batch=self.cfg.member_batch)
        out = self.programs((A, B, guidance), lambda *args: gen(*args, guidance_scale=guidance),
                            stacked, ids_t, keys)
        self.registry.inc("serve_padded_slots", A - n)
        return out[:n].to(torch.float32).cpu().numpy()

    def warmup(self, geometries: Optional[Sequence[Tuple[int, Optional[float]]]] = None) -> List[str]:
        """Run each ``(images_per_request, guidance)`` geometry once at full
        ``adapter_batch`` with zero adapters (builds kernels, warms
        allocators). Returns a label per geometry."""
        geoms = list(geometries) if geometries else [(self.cfg.images_per_request, None)]
        zeros = tree_map(torch.zeros_like, self.template)
        labels = []
        for B, g in geoms:
            A = self.cfg.adapter_batch
            self._run([zeros] * A, [[0] * B] * A, [0] * A, g)
            labels.append(f"serve_a{A}b{B}" + (f"_g{g:g}" if g is not None else ""))
        return labels

    # -- request path --------------------------------------------------------
    def submit(self, adapter_id: str, prompt_ids: Sequence[int], seed: int,
               guidance: Optional[float] = None) -> ServeRequest:
        """Enqueue one request. A non-resident adapter, an empty or
        out-of-range prompt list and a full queue raise here."""
        self.store.entry(adapter_id)  # raises KeyError for a non-resident adapter
        if not prompt_ids:
            raise ValueError("a request needs at least one prompt id")
        bad = [i for i in prompt_ids if not 0 <= int(i) < self.backend.num_items]
        if bad:
            raise ValueError(f"prompt ids {bad} outside the catalog of {self.backend.num_items}")
        req = ServeRequest(adapter_id=adapter_id, prompt_ids=tuple(int(i) for i in prompt_ids),
                           seed=int(seed), guidance=guidance)
        return self.queue.submit(req)

    def _dispatch(self, batch: List[ServeRequest]) -> List[ServeResult]:
        results: List[ServeResult] = []
        good: List[ServeRequest] = []
        thetas, versions = [], []
        for r in batch:
            try:
                version = self.store.entry(r.adapter_id).version
                thetas.append(self.store.get(r.adapter_id))
            except KeyError as exc:
                # one evicted adapter fails its own request, not the batch
                self.counters["refused"] += 1
                print(f"[serve] refused request {r.request_id}: {exc}", file=sys.stderr, flush=True)
                results.append(ServeResult(
                    request=r, images=None, latency_s=time.perf_counter() - r.t_submit,
                    batch_size=0, batch_occupancy=0.0, error=str(exc),
                ))
                continue
            good.append(r)
            versions.append(version)
        if not good:
            return results
        n = len(good)
        t0 = time.perf_counter()
        images = self._run(thetas, [list(r.prompt_ids) for r in good], [r.seed for r in good],
                           good[0].guidance)
        t_done = time.perf_counter()
        self.dispatch_seconds.append(t_done - t0)
        self.counters["dispatches"] += 1
        self.counters["requests"] += n
        self.counters["images"] += n * images.shape[1]
        occupancy = n / self.cfg.adapter_batch
        for i, r in enumerate(good):
            results.append(ServeResult(
                request=r, images=images[i], latency_s=t_done - r.t_submit,
                batch_size=n, batch_occupancy=occupancy, adapter_version=versions[i],
            ))
        return results

    def flush(self, max_batches: Optional[int] = None) -> List[ServeResult]:
        """Coalesce and dispatch queued requests until the queue is empty (or
        ``max_batches`` dispatches); also delivers results that an earlier
        :meth:`generate` call served for other requests."""
        results: List[ServeResult] = list(self._undelivered)
        self._undelivered.clear()
        dispatched = 0
        while self.queue.depth:
            if max_batches is not None and dispatched >= max_batches:
                break
            batch = self.queue.take_batch(self.cfg.adapter_batch)
            if not batch:
                break
            results.extend(self._dispatch(batch))
            dispatched += 1
        return results

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

    def stats(self) -> Dict[str, Any]:
        return {
            **self.counters,
            "dispatch_seconds": list(self.dispatch_seconds),
            "queue_depth": self.queue.depth,
            "device": str(self.device),
            "store": self.store.stats(),
            **self.registry.snapshot(),
            "programs": self.programs.stats(),
        }
