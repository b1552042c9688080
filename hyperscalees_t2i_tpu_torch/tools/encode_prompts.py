"""Prompt lists → encoded-prompt caches for every backend (port of
``hyperscalees_t2i_tpu/tools/encode_prompts.py``)::

    python -m hyperscalees_t2i_tpu_torch.tools.encode_prompts --tsv data/parti_prompts_sample.tsv \
        --format sana --encoder /models/gemma-2-2b-it --out parti.npz

Encoders, in order of preference:
1. a Hugging Face text encoder from local files (a directory, or a model in
   the local cache; nothing is downloaded), run on ``--device`` (default:
   the CUDA card). The defaults per format are the reference stacks' (Gemma-2
   for Sana, Qwen for Z-Image, T5 for Infinity); an encoder-decoder config
   runs its encoder only.
2. ``--fallback hash``: deterministic pseudo-embeddings from stable text
   hashes, ``normal(fold_in(PRNGKey(20260729), stable_text_seed(text)),
   (L, dim))`` in the JAX package's stream. For smoke tests and geometry
   checks only; it needs the flag and prints a warning.

Inputs: ``--prompts`` (txt, one per line, ``#`` comments) or ``--tsv``
(PartiPrompts-style, ``Prompt`` column). Output: the ``.npz`` cache the
chosen backend loads (``utils/prompt_cache.py``), readable by both packages.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

DEFAULT_ENCODERS = {
    # the reference stacks' text encoders
    "sana": "google/gemma-2-2b-it",
    "zimage": "Qwen/Qwen2.5-VL-3B-Instruct",
    "infinity": "google/flan-t5-xl",
}
DEFAULT_MAX_LEN = {"sana": 300, "zimage": 512, "infinity": 512}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Encode prompts into a backend cache")
    p.add_argument("--prompts", default=None, help="txt file, one prompt per line")
    p.add_argument("--tsv", default=None, help="PartiPrompts-style TSV")
    p.add_argument("--tsv_column", default="Prompt")
    p.add_argument("--format", required=True, choices=["sana", "zimage", "infinity"])
    p.add_argument("--out", required=True, help="output cache (.npz)")
    p.add_argument("--encoder", default=None, help="HF text-encoder name/path")
    p.add_argument("--max_length", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--fallback", default="error", choices=["error", "hash"],
                   help="behavior when the HF encoder is unavailable")
    p.add_argument("--dim", type=int, default=0,
                   help="embedding dim for the hash fallback (required with it "
                        "unless the encoder loads)")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    p.add_argument("--enable_positive_prompt", action="store_true",
                   help="append the Infinity face-quality suffix to prompts "
                        "that mention a person before encoding (the train "
                        "CLI's --enable_positive_prompt)")
    return p


def read_prompts(args) -> List[str]:
    from ..utils.prompt_cache import load_partiprompts_tsv, load_prompts_txt

    if bool(args.prompts) == bool(args.tsv):
        sys.exit("ERROR: pass exactly one of --prompts / --tsv")
    prompts = (
        load_prompts_txt(args.prompts) if args.prompts
        else load_partiprompts_tsv(args.tsv, args.tsv_column)
    )
    if args.limit:
        prompts = prompts[: args.limit]
    if not prompts:
        sys.exit("ERROR: no prompts found")
    return prompts


class EncoderUnavailable(Exception):
    """Text encoder could not be loaded (not cached / wrong env / bad name)."""


def encode_hf(
    prompts: List[str], model_name: str, max_length: int, batch_size: int, device: DeviceLike = None
) -> Tuple[np.ndarray, np.ndarray]:
    """[P, L, D] last-hidden-state embeddings + [P, L] attention mask, the
    model run in f32 on ``device`` (default: the CUDA card).

    Only *load-time* failures raise :class:`EncoderUnavailable` (and are
    eligible for the hash fallback); a crash inside the encode loop is a real
    bug and propagates.
    """
    dev = resolve_device(device)
    try:
        from transformers import AutoConfig, AutoModel, AutoTokenizer

        tok = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
        cfg = AutoConfig.from_pretrained(model_name, local_files_only=True)
        if getattr(cfg, "is_encoder_decoder", False):
            from transformers import T5EncoderModel

            model = T5EncoderModel.from_pretrained(model_name, torch_dtype=torch.float32, local_files_only=True)
        else:
            model = AutoModel.from_pretrained(model_name, torch_dtype=torch.float32, local_files_only=True)
    except (ImportError, OSError, ValueError, KeyError) as e:
        # OSError: not in the local files; ValueError: HFValidationError
        # subclass (malformed name); KeyError: unknown model_type registry miss
        raise EncoderUnavailable(f"{type(e).__name__}: {e}") from e
    model.to(dev).eval()

    embeds, masks = [], []
    with torch.no_grad():
        for i in range(0, len(prompts), batch_size):
            batch = prompts[i : i + batch_size]
            enc = tok(
                batch, padding="max_length", truncation=True,
                max_length=max_length, return_tensors="pt",
            )
            out = model(input_ids=enc["input_ids"].to(dev), attention_mask=enc["attention_mask"].to(dev))
            embeds.append(out.last_hidden_state.float().cpu().numpy())
            masks.append(enc["attention_mask"].numpy().astype(bool))
            print(f"[encode] {min(i + batch_size, len(prompts))}/{len(prompts)}", flush=True)
    return np.concatenate(embeds), np.concatenate(masks)


def encode_hash_fallback(
    prompts: List[str], dim: int, max_length: int, device: DeviceLike = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic pseudo-embeddings (stable across hosts and restarts),
    drawn on ``device`` (default: the CUDA card)."""
    from ..utils import threefry
    from ..utils.seeding import stable_text_seed

    dev = resolve_device(device)
    L = min(max_length, 64)  # fallback embeds don't need full padding length
    root = threefry.prng_key(20260729, dev)
    rows = [threefry.normal(threefry.fold_in(root, stable_text_seed(p)), (L, dim)).cpu().numpy() for p in prompts]
    lens = [max(1, min(len(p.split()) + 2, L)) for p in prompts]
    embeds = np.stack(rows)
    mask = np.arange(L)[None, :] < np.asarray(lens)[:, None]
    return embeds, mask


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    prompts = read_prompts(args)
    if args.enable_positive_prompt:
        from ..utils.prompt_cache import aug_with_positive_prompt

        # augmentation happens before encoding: the cache stores the
        # augmented text alongside its embeddings
        prompts = [aug_with_positive_prompt(p) for p in prompts]
    fmt = args.format
    model_name = args.encoder or DEFAULT_ENCODERS[fmt]
    max_length = args.max_length or DEFAULT_MAX_LEN[fmt]

    try:
        embeds, mask = encode_hf(prompts, model_name, max_length, args.batch_size, args.device)
        source = model_name
    except EncoderUnavailable as e:
        if args.fallback != "hash":
            sys.exit(
                f"ERROR: text encoder {model_name!r} unavailable ({type(e).__name__}: {e}).\n"
                "Pass --fallback hash for deterministic smoke embeddings "
                "(NOT meaningful against real checkpoints), or --encoder with "
                "a locally-cached model."
            )
        if not args.dim:
            sys.exit("ERROR: --fallback hash needs --dim (the model's text width)")
        print(
            f"[encode] WARNING: {model_name!r} unavailable → hash-fallback "
            "pseudo-embeddings (smoke only; scores vs real checkpoints are "
            "meaningless)",
            flush=True,
        )
        embeds, mask = encode_hash_fallback(prompts, args.dim, max_length, args.device)
        source = "hash-fallback"

    from ..utils.prompt_cache import save_infinity_cache, save_sana_cache, save_zimage_cache

    if fmt == "sana":
        save_sana_cache(args.out, prompts, embeds, mask)
    elif fmt == "zimage":
        save_zimage_cache(args.out, prompts, embeds, mask)
    else:
        save_infinity_cache(args.out, prompts, embeds, mask)
    print(
        f"[encode] wrote {len(prompts)} prompts × {embeds.shape[1]}×{embeds.shape[2]} "
        f"({source}) → {args.out}",
        flush=True,
    )


if __name__ == "__main__":
    main()
