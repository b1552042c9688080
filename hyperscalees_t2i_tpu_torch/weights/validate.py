"""One-command validation of a converted checkpoint (port of
``hyperscalees_t2i_tpu/weights/validate.py``)::

    python -m hyperscalees_t2i_tpu_torch.weights.validate \\
        --family sana --weights ckpt.safetensors [--vae_weights vae.pth] \\
        [--expect stats.json] [--write_expected stats.json] [--device cpu]

Converts a checkpoint through the train CLI's ``build_backend`` (so geometry
inference and flag coupling are the training run's), generates a small
deterministic batch with the base model (θ₀ of a fresh run: a zero LoRA
delta), prints one JSON line of summary statistics, and with ``--expect``
compares them against a stored stats file within ``--atol``, exiting 1 on a
mismatch. ``--write_expected`` records this run's stats. The schema is the
JAX package's (``generation_stats``), so a stats file either package wrote
is checked by the other. ``--family zimage`` takes a Z-Image transformer
(``.gguf`` too) and, as ``--vae_weights``, its ``AutoencoderKL``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

FAMILIES = ("sana", "var", "zimage", "infinity")

# |measured − expected| tolerance of the float stat fields: mean/std-level
# aggregates of generations in the model's compute dtype
DEFAULT_ATOL = 5e-3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m hyperscalees_t2i_tpu_torch.weights.validate",
                                description=__doc__.splitlines()[0])
    p.add_argument("--family", required=True, choices=FAMILIES)
    p.add_argument("--weights", required=True, help="checkpoint file/dir to validate")
    p.add_argument("--vae_weights", default=None,
                   help="VAE / tokenizer checkpoint (var requires it; infinity and zimage optional)")
    p.add_argument("--prompts_txt", default=None, help="prompt list; defaults to the backend's built-in prompt")
    p.add_argument("--encoded_prompts", default=None, help="encoded-prompt cache (families that need real text embeds)")
    p.add_argument("--images", type=int, default=4, help="images to generate (≤ prompts)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--expect", default=None, help="expected-stats JSON to compare against (exit 1 on mismatch)")
    p.add_argument("--write_expected", default=None, help="write this run's stats as the expected-stats JSON")
    p.add_argument("--atol", type=float, default=DEFAULT_ATOL)
    p.add_argument("--infinity_variant", default=None)
    p.add_argument("--pn", default=None)
    p.add_argument("--model_scale", default="full", choices=["tiny", "small", "full"])
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p


def _build_backend(args, device):
    """The train CLI's backend for the family and the checkpoint."""
    from ..train.cli import build_backend, build_parser as train_parser

    family = "sana_one_step" if args.family == "sana" else args.family
    argv = ["--backend", family, "--weights", args.weights, "--model_scale", args.model_scale]
    for flag in ("vae_weights", "prompts_txt", "encoded_prompts", "infinity_variant", "pn"):
        if getattr(args, flag):
            argv += [f"--{flag}", getattr(args, flag)]
    return build_backend(train_parser().parse_args(argv), device)


def generation_stats(args) -> dict:
    import torch

    from ..device import resolve_device
    from ..utils import threefry

    device = resolve_device(args.device)
    backend = _build_backend(args, device)
    backend.setup()
    m = max(1, min(args.images, backend.num_items))
    flat_ids = list(backend.step_info(args.seed, m, 1).flat_ids[:m])
    theta = backend.init_theta(threefry.prng_key(args.seed, device))
    with torch.inference_mode():
        imgs = backend.generate(theta, flat_ids, threefry.prng_key(args.seed + 1, device))
    imgs = imgs.float().cpu().numpy()
    if not np.all(np.isfinite(imgs)):
        raise SystemExit("ERROR: generated images contain non-finite values")
    # the 8×8 mean grid of the first image: a spatial fingerprint that
    # catches transposed kernels or wrong norm wiring that global stats miss
    im0 = imgs[0]
    h, w = im0.shape[:2]
    if h >= 8 and w >= 8:
        gh, gw = h // 8, w // 8
        grid = im0[: gh * 8, : gw * 8].reshape(8, gh, 8, gw, -1).mean(axis=(1, 3, 4))
    else:
        grid = np.full((8, 8), float(im0.mean()))
    return {
        "family": args.family,
        "checkpoint": Path(args.weights).name,
        "images": int(imgs.shape[0]),
        "shape": list(imgs.shape[1:]),
        "seed": args.seed,
        "mean": [round(float(x), 6) for x in imgs.mean(axis=(1, 2, 3))],
        "std": [round(float(x), 6) for x in imgs.std(axis=(1, 2, 3))],
        "min": round(float(imgs.min()), 6),
        "max": round(float(imgs.max()), 6),
        "grid8": [[round(float(v), 6) for v in row] for row in grid],
    }


def compare_stats(got: dict, want: dict, atol: float) -> list:
    """Human-readable mismatches (empty: they agree)."""
    errs = []
    for k in ("family", "images", "shape", "seed"):
        if got.get(k) != want.get(k):
            errs.append(f"{k}: got {got.get(k)!r} want {want.get(k)!r}")
    for k in ("mean", "std", "min", "max", "grid8"):
        if k not in want:
            continue
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        if g.shape != w.shape:
            errs.append(f"{k}: shape {g.shape} vs {w.shape}")
        elif not np.allclose(g, w, atol=atol, rtol=0):
            errs.append(f"{k}: max |Δ| = {np.max(np.abs(g - w)):.6f} > atol {atol}")
    return errs


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    stats = generation_stats(args)
    print(json.dumps(stats))
    if args.write_expected:
        Path(args.write_expected).write_text(json.dumps(stats, indent=1))
        print(f"[validate] expected stats written: {args.write_expected}", file=sys.stderr)
    if args.expect:
        errs = compare_stats(stats, json.loads(Path(args.expect).read_text()), args.atol)
        if errs:
            for e in errs:
                print(f"[validate] MISMATCH {e}", file=sys.stderr)
            return 1
        print(f"[validate] OK: stats match {args.expect} (atol {args.atol})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
