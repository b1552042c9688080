"""Score a folder of benchmark images with the reward suite (port of
``hyperscalees_t2i_tpu/evaluate/score_folder.py``)::

    python -m hyperscalees_t2i_tpu_torch.evaluate.score_folder --folder bench/lora \\
        --parti_tsv data/parti_prompts_sample.tsv --out_json lora.json

Each ``{idx:04d}_{slug}.png`` is joined by its index against the
PartiPrompts TSV (Prompt/Category/Challenge columns), scored in batches on
the device through ``rewards.suite``, and the overall, per-Category and
per-Challenge means of every reward are printed as the reference's JSON
report. Images are read by ``utils.images.read_png`` and resized by
``resize_bicubic`` (Pillow's ``Image.BICUBIC``, bitwise): the port needs no
Pillow, and so reads no JPEG (``.jpg``/``.jpeg`` files raise). The towers
are the train CLI's: ``load_clip_tower`` from local Hugging Face files,
``--tiny_towers`` the random tiny tower of ``PRNGKey(11)``.
"""

from __future__ import annotations

import argparse
import csv
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_IDX_RE = re.compile(r"^(\d+)[_\-.]")
REWARD_KEYS = ("clip_aesthetic", "clip_text", "no_artifacts", "pickscore", "combined")


def parse_index(filename: str) -> Optional[int]:
    """``0042_a-cat.png`` → 42."""
    m = _IDX_RE.match(Path(filename).name)
    return int(m.group(1)) if m else None


def load_parti_tsv(path: str) -> List[Dict[str, str]]:
    """PartiPrompts TSV rows with Prompt/Category/Challenge columns."""
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def prepare_images(images: Sequence[np.ndarray], size: int) -> np.ndarray:
    """``[H, W, 3]`` uint8 images → ``[n, size, size, 3]`` f32 in [0, 1],
    resized as Pillow's ``Image.BICUBIC``."""
    from ..utils.images import resize_bicubic

    out = np.zeros((len(images), size, size, 3), np.float32)
    for i, img in enumerate(images):
        out[i] = np.asarray(resize_bicubic(img, (size, size)), np.float32) / 255.0
    return out


def load_images(paths: List[Path], size: int) -> np.ndarray:
    """The PNG files at ``paths`` → ``[n, size, size, 3]`` f32, the
    reference's ``Image.open(p).convert("RGB").resize((size, size),
    Image.BICUBIC) / 255``."""
    from ..utils.images import read_png

    return prepare_images([read_png(p) for p in paths], size)


def aggregate(per_image: Dict[str, np.ndarray], groups: Dict[str, List[int]]):
    """Mean of every reward key, overall and per group."""
    report = {"overall": {k: float(np.mean(v)) for k, v in per_image.items()}}
    for gname, idxs in groups.items():
        if idxs:
            report[gname] = {k: float(np.mean(v[idxs])) for k, v in per_image.items()}
    return report


def build_parser() -> argparse.ArgumentParser:
    from ..train.cli import str2bool

    p = argparse.ArgumentParser(description="Score a benchmark image folder (PyTorch port)")
    p.add_argument("--folder", required=True)
    p.add_argument("--parti_tsv", default=None, help="PartiPrompts TSV (Prompt/Category/Challenge)")
    p.add_argument("--prompts_txt", default=None, help="fallback prompt list when no TSV")
    p.add_argument("--out_json", default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--clip_model", default="openai/clip-vit-base-patch32")
    p.add_argument("--pickscore_model", default="yuvalkirstain/PickScore_v1")
    p.add_argument("--use_pickscore", type=str2bool, default=True)
    p.add_argument("--allow_random_rewards", type=str2bool, default=False)
    p.add_argument("--tiny_towers", action="store_true", help="tiny random towers (tests)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p


def reward_for_prompts(clip_model, prompts: List[str], clip_name: str, pick_model=None,
                       pick_name: Optional[str] = None):
    """The reward suite over ``prompts``: the CLIP text table (the prompts,
    then the aesthetic and negative texts) and, with a PickScore tower, its
    prompt embeddings, each tokenized by ``tokenize_with_hf`` with its
    tower's tokenizer name and encoded by the tower on its device."""
    from ..rewards.suite import (AESTHETIC_TEXT, NEGATIVE_TEXT, clip_text_embed_table, make_clip_reward_fn,
                                 pickscore_text_embeds, tokenize_with_hf)

    dev = clip_model.token_embed.device
    with torch.inference_mode():
        ids, eot, mask = (t.to(dev) for t in tokenize_with_hf(prompts + [AESTHETIC_TEXT, NEGATIVE_TEXT], clip_name))
        table = clip_text_embed_table(clip_model, ids, eot, mask)
        pick = None
        if pick_model is not None:
            pids, peot, pmask = (t.to(dev) for t in tokenize_with_hf(prompts, pick_name))
            pick = pickscore_text_embeds(pick_model, pids, peot, pmask)
    return make_clip_reward_fn(clip_model, table, pick_model=pick_model, pick_text_embeds=pick)


def _towers(args, prompts: List[str], device: torch.device):
    from ..models import clip as clip_mod
    from ..utils import threefry

    pick_model = None
    if args.tiny_towers:
        tower = clip_mod.CLIPTowerConfig(16, 2, 2, 32)
        ccfg = clip_mod.CLIPConfig(vision=tower, text=tower, image_size=32, patch_size=16, vocab_size=49408,
                                   max_positions=77, projection_dim=16)
        cparams = clip_mod.init_clip(ccfg, threefry.prng_key(11, device))
    else:
        from ..train.cli import load_clip_tower

        ccfg = clip_mod.CLIP_B32
        cparams = load_clip_tower(args.clip_model, ccfg, device)
        pparams = load_clip_tower(args.pickscore_model, clip_mod.CLIP_H14, device) if args.use_pickscore else None
        if pparams is not None:
            pick_model = clip_mod.CLIPModel(clip_mod.CLIP_H14, pparams)
        if cparams is None:
            if not args.allow_random_rewards:
                raise SystemExit("CLIP weights unavailable; pass --allow_random_rewards true")
            cparams = clip_mod.init_clip(ccfg, threefry.prng_key(11, device))
    return reward_for_prompts(clip_mod.CLIPModel(ccfg, cparams), prompts, args.clip_model, pick_model,
                              args.pickscore_model)


def index_folder(folder) -> List[Tuple[int, Path]]:
    """``(prompt index, file)`` of every ``.png``/``.jpg``/``.jpeg`` file whose
    name starts with an index, in name order."""
    files = sorted(p for p in Path(folder).iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
    return [(idx, f) for f in files if (idx := parse_index(f.name)) is not None]


def score_images(reward_fn, items: Sequence[Tuple[int, object]], num_prompts: int, batch_size: int,
                 image_size: int, device: torch.device,
                 load: Callable[[List[object], int], np.ndarray] = load_images,
                 log: Callable[[str], None] = print) -> Tuple[Dict[str, np.ndarray], List[int]]:
    """Score ``(prompt index, image source)`` items in batches of
    ``batch_size`` on ``device``: ``load`` turns a batch's sources into
    ``[n, image_size, image_size, 3]`` f32 (default: PNG paths through
    :func:`load_images`). Returns each reward's per-image values and the
    items' prompt indices, in order."""
    acc = {k: [] for k in REWARD_KEYS}
    order: List[int] = []
    with torch.inference_mode():
        for s in range(0, len(items), batch_size):
            chunk = items[s:s + batch_size]
            imgs = torch.from_numpy(load([src for _, src in chunk], image_size)).to(device)
            pids = torch.tensor([min(i, num_prompts - 1) for i, _ in chunk], dtype=torch.long).to(device)
            out = reward_fn(imgs, pids)
            for k in REWARD_KEYS:
                acc[k].append(out[k].to(torch.float32).cpu().numpy())
            order.extend(i for i, _ in chunk)
            log(f"[score] {min(s + batch_size, len(items))}/{len(items)}")
    return {k: np.concatenate(v) for k, v in acc.items()}, order


def build_report(per_image: Dict[str, np.ndarray], order: List[int],
                 rows: Optional[List[Dict[str, str]]]) -> Dict:
    """The reference's report: overall and per-Category/per-Challenge means
    (images whose index has a TSV row) and ``num_images``."""
    groups: Dict[str, List[int]] = defaultdict(list)
    if rows is not None:
        for pos, idx in enumerate(order):
            if idx < len(rows):
                groups[f"category/{rows[idx].get('Category', '?')}"].append(pos)
                groups[f"challenge/{rows[idx].get('Challenge', '?')}"].append(pos)
    report = aggregate(per_image, groups)
    report["num_images"] = len(order)
    return report


def main(argv: Optional[List[str]] = None) -> dict:
    from ..device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    indexed = index_folder(args.folder)
    if not indexed:
        raise SystemExit(f"no indexed images in {args.folder}")
    rows = load_parti_tsv(args.parti_tsv) if args.parti_tsv else None
    if rows is not None:
        prompts = [r.get("Prompt", "") for r in rows]
    elif args.prompts_txt:
        from ..utils.prompt_cache import load_prompts_txt

        prompts = load_prompts_txt(args.prompts_txt)
    else:
        prompts = [""] * (max(i for i, _ in indexed) + 1)
    reward_fn = _towers(args, prompts, device)
    per_image, order = score_images(reward_fn, indexed, len(prompts), args.batch_size, args.image_size, device,
                                    log=lambda m: print(m, flush=True))
    report = build_report(per_image, order, rows)
    text = json.dumps(report, indent=2, sort_keys=True)
    print(text)
    if args.out_json:
        Path(args.out_json).write_text(text)
    return report


if __name__ == "__main__":
    main()
