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
program. ``--tp`` above 1 (the reference's tensor-parallel mesh) raises:
tensor parallelism is ROADMAP queue A item 7 part 4.
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
                   help="shard generator weights over N devices; above 1 raises (multi-GPU is not ported)")
    return p


def make_backend(args):
    """The set-up backend of the parsed flags on ``--device``, built by the
    train CLI's ``build_backend`` (its backend flags at their defaults where
    this parser has none)."""
    from ..device import resolve_device
    from ..train.cli import add_backend_flags, build_backend

    if args.tp and args.tp > 1:
        raise NotImplementedError(f"--tp {args.tp}: sharding the generator over several GPUs is ROADMAP queue A "
                                  "item 7 part 4 (tensor parallelism); run with --tp 0")
    ns = add_backend_flags(argparse.ArgumentParser()).parse_args(["--backend", args.backend])
    for k, v in vars(args).items():
        if hasattr(ns, k):
            setattr(ns, k, v)
    backend = build_backend(ns, resolve_device(args.device))
    backend.setup()
    return backend


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
                    log: Callable[[str], None] = print) -> List[Path]:
    """Generate the first ``limit`` catalog prompts (0: all) of a set-up
    ``backend`` with adapter ``theta`` into ``out_dir``, ``batch_size`` at a
    time, batch ``start`` from ``PRNGKey(start)``; returns the files in
    prompt order. ``programs`` holds one program per batch geometry (default:
    a new ``GraphCache`` on the backend's device); ``sink`` receives each
    image as f32 ``[H, W, 3]`` before it is rounded to uint8."""
    from ..lora import stack_adapters
    from ..utils.images import save_image
    from ..utils.pytree import tree_map

    dev = backend.device
    n = backend.num_items if not limit else min(limit, backend.num_items)
    out_dir = Path(out_dir)
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
                save_image(imgs[j], path)
                paths.append(path)
                if sink is not None:
                    sink.append(imgs[j])
            log(f"[bench] {min(start + batch_size, n)}/{n}")
    log(f"[bench] wrote {n} images to {out_dir}")
    return paths


def main(argv: Optional[List[str]] = None) -> List[Path]:
    args = build_parser().parse_args(argv)
    backend = make_backend(args)
    theta = load_theta(backend, args.mode, args.adapter_run_dir)
    return generate_folder(backend, theta, args.out_dir, args.batch_size, args.limit,
                           log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    main()
