"""Benchmark image generation: one image per prompt, base model or trained
adapter (port of ``hyperscalees_t2i_tpu/evaluate/run_benchmark.py``)::

    python -m hyperscalees_t2i_tpu_torch.evaluate.run_benchmark --backend sana_one_step \\
        --encoded_prompts parti.npz --mode lora --adapter_run_dir runs/x --out_dir bench/lora

``--mode base`` generates with θ = 0 (every LoRA delta vanishes), ``--mode
lora`` with the newest checkpoint of ``--adapter_run_dir`` (a slot or
``latest_theta.npz``, written by either package). Batch ``i`` starting at
prompt ``start`` draws from ``PRNGKey(start)``, as the reference seeds it;
files are ``{idx:04d}_{slug}.png``.

The reference jits one program per batch with θ as an argument; here
:func:`generate_folder` runs one program per batch geometry through
``utils.graphs.GraphCache``: on the card a CUDA graph for the full batch and
one for a shorter last batch, θ, prompt ids and key copied in as inputs, the
frozen weights read from the backend's buffers. Base and LoRA are the same
program.

``--tp N`` above 1 shards the generator's weights over the N processes of a
launch (``parallel/tp.py``: the JAX package's rules, the collectives written
out on a gloo group), each process on its card (``parallel.mesh``); every
process generates and rank 0 writes the images. The launch is given as the
train CLI's (``--coordinator host:port --num_processes N --process_id i``,
or the launcher's variables); a launch of another size raises. The sharded
generate runs eagerly: its collectives cannot be captured in a CUDA graph.
``--tp 0`` and ``--tp 1`` are the one-process path.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..utils import threefry
from ..utils.graphs import GraphCache


def slugify(text: str, max_len: int = 48) -> str:
    """Filename slug of a prompt (the reference's)."""
    s = re.sub(r"[^a-z0-9]+", "-", text.lower()).strip("-")
    return s[:max_len] or "prompt"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PartiPrompts benchmark generation (PyTorch port)")
    p.add_argument("--backend", default="sana_one_step",
                   choices=["sana_one_step", "sana_pipeline", "var", "zimage", "infinity"])
    p.add_argument("--model_scale", default="full", choices=["tiny", "small", "full"])
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    p.add_argument("--mode", default="base", choices=["base", "lora"])
    p.add_argument("--adapter_run_dir", default=None, help="run dir containing latest_theta.npz (mode=lora)")
    p.add_argument("--encoded_prompts", default=None)
    p.add_argument("--prompts_txt", default=None)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_inference_steps", type=int, default=None)
    p.add_argument("--guidance_scale", type=float, default=None)
    p.add_argument("--latent_size", type=int, default=None)
    p.add_argument("--limit", type=int, default=0, help="first N prompts only (0=all)")
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--weights", default=None, help="pretrained generator checkpoint (train.cli --weights)")
    p.add_argument("--vae_weights", default=None)
    p.add_argument("--tp", type=int, default=0,
                   help="shard generator weights over the N processes of a launch (tensor parallelism, "
                        "parallel/tp.py); 0 = no sharding")
    p.add_argument("--coordinator", default=None, help="host:port of process 0's store (a --tp launch)")
    p.add_argument("--num_processes", type=int, default=None, help="processes in the launch (with --coordinator)")
    p.add_argument("--process_id", type=int, default=None, help="this process's rank (with --coordinator)")
    return p


def make_backend(args):
    """The set-up backend of the parsed flags on ``--device`` (in a launch:
    this process's card, ``parallel.mesh.process_device``), built by the
    train CLI's ``build_backend`` (its backend flags at their defaults where
    this parser has none). With ``--tp`` above 1 its generator is sharded
    over the launch (:func:`shard_generator`)."""
    from ..parallel.mesh import process_device
    from ..train.cli import add_backend_flags, build_backend

    if args.tp and args.tp > 1:
        _check_launch(args.tp)  # before the build
    ns = add_backend_flags(argparse.ArgumentParser()).parse_args(["--backend", args.backend])
    for k, v in vars(args).items():
        if hasattr(ns, k):
            setattr(ns, k, v)
    backend = build_backend(ns, process_device(args.device))
    backend.setup()
    if args.tp and args.tp > 1:
        shard_generator(backend, args.backend, args.tp)
    return backend


def _check_launch(tp: int) -> None:
    from ..parallel.collectives import process_count

    if process_count() != tp:
        raise ValueError(f"--tp {tp} shards the generator over a launch of {tp} processes, one card each; this "
                         f"process is in a launch of {process_count()} (start it with --coordinator, "
                         f"--num_processes {tp} and --process_id, or the launcher's variables)")


def shard_generator(backend, backend_name: str, tp: int) -> int:
    """Shard ``backend.model`` over the launch's ``tp`` processes
    (``parallel.tp.shard_module_tp``); returns the leaves sharded. A launch
    of another size raises."""
    from ..parallel.tp import shard_module_tp

    _check_launch(tp)
    family = backend_name.split("_")[0]  # sana_one_step/sana_pipeline → sana
    n_sharded = shard_module_tp(backend.model, family)
    if n_sharded == 0:
        print(f"[bench] WARNING: tp={tp} matched no shardable weights (quantized kernels / non-divisible dims?) — "
              "everything is REPLICATED", flush=True)
    else:
        print(f"[bench] tp={tp}: {n_sharded} weight groups sharded over {tp} devices", flush=True)
    return n_sharded


def load_theta(backend, mode: str, adapter_run_dir: Optional[str]) -> Any:
    """θ of ``mode``: zeros of the backend's adapter structure (base), or
    the newest checkpoint of ``adapter_run_dir`` (lora)."""
    from ..train.checkpoints import load_checkpoint
    from ..utils.pytree import zero_like_theta

    theta = backend.init_theta(threefry.prng_key(0, "cpu"))
    if mode != "lora":
        return zero_like_theta(theta)
    if not adapter_run_dir:
        raise SystemExit("--adapter_run_dir required for mode=lora")
    restored = load_checkpoint(Path(adapter_run_dir), theta)
    if restored is None:
        raise SystemExit(f"no loadable checkpoint in {adapter_run_dir}")
    theta, epoch = restored
    print(f"[bench] loaded adapter from epoch {epoch}", flush=True)
    return theta


def generate_folder(backend, theta: Any, out_dir, batch_size: int = 8, limit: int = 0,
                    programs: Optional[GraphCache] = None, sink: Optional[List[np.ndarray]] = None,
                    log: Callable[[str], None] = print, save: bool = True) -> List[Path]:
    """Generate the first ``limit`` catalog prompts (0: all) of a set-up
    ``backend`` with adapter ``theta`` into ``out_dir``, ``batch_size`` at a
    time, batch ``start`` from ``PRNGKey(start)``; returns the files in
    prompt order. ``programs`` holds one program per batch geometry (default:
    a new ``GraphCache`` on the backend's device); ``sink`` receives each
    image as f32 ``[H, W, 3]`` before it is rounded to uint8. ``save=False``
    generates without writing (the other ranks of a ``--tp`` launch)."""
    from ..lora import stack_adapters
    from ..utils.images import save_image
    from ..utils.pytree import tree_map

    dev = backend.device
    n = backend.num_items if not limit else min(limit, backend.num_items)
    out_dir = Path(out_dir)
    if save:
        out_dir.mkdir(parents=True, exist_ok=True)
    programs = programs if programs is not None else GraphCache(dev)
    stacked = tree_map(lambda t: t.to(dev), stack_adapters([theta]))
    paths: List[Path] = []
    with torch.inference_mode():
        for start in range(0, n, batch_size):
            ids = list(range(start, min(start + batch_size, n)))
            flat = torch.tensor([ids], dtype=torch.long).to(dev)
            key = threefry.prng_key(start, dev)[None]
            out = programs(("benchmark", len(ids)), backend.generate_p, stacked, flat, key)
            imgs = out[0].to(torch.float32).cpu().numpy()
            for j, idx in enumerate(ids):
                path = out_dir / f"{idx:04d}_{slugify(backend.texts[idx])}.png"
                if save:
                    save_image(imgs[j], path)
                    paths.append(path)
                if sink is not None:
                    sink.append(imgs[j])
            log(f"[bench] {min(start + batch_size, n)}/{n}")
    log(f"[bench] wrote {n} images to {out_dir}")
    return paths


def main(argv: Optional[List[str]] = None) -> List[Path]:
    from ..parallel.collectives import is_master
    from ..parallel.mesh import initialize_multihost

    args = build_parser().parse_args(argv)
    if args.coordinator and (args.num_processes is None or args.process_id is None):
        raise SystemExit("--coordinator needs --num_processes and --process_id")
    initialize_multihost(args.coordinator, args.num_processes, args.process_id)
    backend = make_backend(args)
    theta = load_theta(backend, args.mode, args.adapter_run_dir)
    tp = bool(args.tp and args.tp > 1)
    # the sharded forward's collectives cannot sit in a CUDA graph: eager
    programs = GraphCache(backend.device, graph=False) if tp else None
    return generate_folder(backend, theta, args.out_dir, args.batch_size, args.limit, programs=programs,
                           log=lambda m: print(m, flush=True) if is_master() else None, save=is_master())


if __name__ == "__main__":
    main()
