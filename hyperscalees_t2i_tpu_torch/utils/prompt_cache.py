"""Encoded-prompt caches: the prompt file, positive-prompt augmentation and
the Sana and Infinity caches (port of ``hyperscalees_t2i_tpu/utils/
prompt_cache.py``; numpy and the standard library, plus ``torch.load`` /
``torch.save`` for ``.pt`` payloads).

- A Sana cache is ``.npz`` (``prompts``, ``prompt_embeds [P, L, D]``,
  ``prompt_attention_mask [P, L]``) or the reference's ``.pt`` payload with
  the same keys (:func:`load_sana_cache`, :func:`save_sana_cache`).
- An Infinity cache is ``.npz`` (``prompts``, ``text_emb [P, L, D]``,
  ``text_mask [P, L]``, as :func:`save_infinity_cache` writes it) or the
  reference's ``.pt`` payload ``{"prompts", "kv_compact_list": [Tensor
  [Li, D]], "lens_list"}``, padded to one table and a mask at load time.
- A Z-Image cache is ``.npz`` (``prompts``, ``prompt_embeds [P, L, D]``,
  ``prompt_mask [P, L]``, as :func:`save_zimage_cache` writes it) or the
  reference's ``.pt`` payload ``{"prompts", "prompt_embeds": [Tensor [Li,
  D]]}``, padded to one table and a mask at load time (``max_len`` caps it).

:func:`load_cache` stamps a payload with the file's sha256 and keeps it in
a warm memo keyed by content (backend kind, sha256, ``max_len``): a second
load of the same bytes returns the same payload and ticks
``prompt_cache_warm_hits`` on the process-global registry.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Any, Dict, List, Sequence

import numpy as np

from ..resilience.retry import call_with_retry

# Positive-prompt augmentation: a prompt that mentions a person gets a
# face-quality suffix before text encoding. The keyword list and the plain
# substring rule are the reference's ("humane" matches "human").
_PERSON_KEYWORDS = (
    "man", "woman", "men", "women", "boy", "girl", "child", "person", "human",
    "adult", "teenager", "employee", "employer", "worker", "mother", "father",
    "sister", "brother", "grandmother", "grandfather", "son", "daughter",
)
POSITIVE_PROMPT_SUFFIX = (
    ". very smooth faces, good looking faces, face to the camera, "
    "perfect facial features"
)
# backend family → cache format (each with its reader below)
_CACHE_KINDS = ("infinity", "sana", "zimage")
# (kind, file sha256, max_len) → the loaded payload (callers must not mutate it)
_WARM_CACHES: Dict[tuple, Dict[str, Any]] = {}


def aug_with_positive_prompt(prompt: str) -> str:
    """The prompt with the face-quality suffix appended once when any person
    keyword is a substring of it."""
    for key in _PERSON_KEYWORDS:
        if key in prompt:
            return prompt + POSITIVE_PROMPT_SUFFIX
    return prompt


def _read_prompts(path: str) -> List[str]:
    lines = Path(path).read_text(encoding="utf-8").splitlines()
    return [l.strip() for l in lines if l.strip() and not l.strip().startswith("#")]


def load_prompts_txt(path: str) -> List[str]:
    """The file's non-empty lines that do not start with ``#``, stripped."""
    return call_with_retry(_read_prompts, (path,), site="prompt_cache")


def pad_ragged(arrs, lens=None, max_len: int = 0):
    """Ragged ``[Li, D]`` arrays → ``(embeds [P, Lmax, D] f32, mask [P,
    Lmax] bool)``; row ``i`` keeps its first ``min(lens[i], Lmax, Li)``
    positions. ``max_len`` (0: the longest) fixes ``Lmax``."""
    arrs = [np.asarray(a, np.float32) for a in arrs]
    if lens is None:
        lens = [a.shape[0] for a in arrs]
    L = max_len or max(int(n) for n in lens)
    D = arrs[0].shape[-1]
    embeds = np.zeros((len(arrs), L, D), np.float32)
    mask = np.zeros((len(arrs), L), bool)
    for i, (a, n) in enumerate(zip(arrs, lens)):
        n = min(int(n), L, a.shape[0])
        embeds[i, :n] = a[:n]
        mask[i, :n] = True
    return embeds, mask


def _to_np(x) -> np.ndarray:
    return np.asarray(x.float().numpy() if hasattr(x, "numpy") else x, np.float32)


def _read_sana_cache(path: str) -> Dict[str, Any]:
    p = Path(path)
    if p.suffix == ".npz":
        with np.load(p, allow_pickle=True) as z:
            return {"prompts": list(z["prompts"]), "prompt_embeds": z["prompt_embeds"],
                    "prompt_attention_mask": z["prompt_attention_mask"]}
    import torch

    data = torch.load(p, map_location="cpu", weights_only=True)
    embeds, mask = data["prompt_embeds"], data["prompt_attention_mask"]
    if hasattr(embeds, "numpy"):
        embeds = embeds.float().numpy()
    if hasattr(mask, "numpy"):
        mask = mask.numpy()
    return {"prompts": list(data["prompts"]), "prompt_embeds": np.asarray(embeds),
            "prompt_attention_mask": np.asarray(mask)}


def load_sana_cache(path: str) -> Dict[str, Any]:
    """A Sana cache → ``{"prompts", "prompt_embeds", "prompt_attention_mask"}``."""
    return call_with_retry(_read_sana_cache, (path,), site="prompt_cache")


def save_sana_cache(path: str, prompts: Sequence[str], prompt_embeds: np.ndarray,
                    prompt_attention_mask: np.ndarray) -> None:
    """Write a Sana cache: ``.npz`` by suffix, else the ``.pt`` payload
    (parent directories made)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    if p.suffix == ".npz":
        np.savez(p, prompts=np.asarray(list(prompts), dtype=object),
                 prompt_embeds=np.asarray(prompt_embeds, np.float32),
                 prompt_attention_mask=np.asarray(prompt_attention_mask))
        return
    import torch

    torch.save({"prompts": list(prompts),
                "prompt_embeds": torch.from_numpy(np.asarray(prompt_embeds, np.float32)),
                "prompt_attention_mask": torch.from_numpy(np.asarray(prompt_attention_mask))}, p)


def _read_zimage_cache(path: str, max_len: int) -> Dict[str, Any]:
    p = Path(path)
    if p.suffix == ".npz":
        z = np.load(p, allow_pickle=True)
        return {"prompts": list(z["prompts"]), "prompt_embeds": z["prompt_embeds"], "prompt_mask": z["prompt_mask"]}
    import torch

    data = torch.load(p, map_location="cpu", weights_only=True)
    embeds, mask = pad_ragged([_to_np(e) for e in data["prompt_embeds"]], max_len=max_len)
    return {"prompts": list(data["prompts"]), "prompt_embeds": embeds, "prompt_mask": mask}


def load_zimage_cache(path: str, max_len: int = 0) -> Dict[str, Any]:
    """A Z-Image cache → ``{"prompts", "prompt_embeds", "prompt_mask"}``."""
    return call_with_retry(_read_zimage_cache, (path, max_len), site="prompt_cache")


def save_zimage_cache(path: str, prompts: Sequence[str], prompt_embeds: np.ndarray, prompt_mask: np.ndarray) -> None:
    """Write the ``.npz`` form of a Z-Image cache (parent directories made)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, prompts=np.asarray(list(prompts), dtype=object),
             prompt_embeds=np.asarray(prompt_embeds, np.float32), prompt_mask=np.asarray(prompt_mask, bool))


def _read_infinity_cache(path: str, max_len: int) -> Dict[str, Any]:
    p = Path(path)
    if p.suffix == ".npz":
        z = np.load(p, allow_pickle=True)
        return {"prompts": list(z["prompts"]), "text_emb": z["text_emb"], "text_mask": z["text_mask"]}
    import torch

    data = torch.load(p, map_location="cpu", weights_only=True)
    emb, mask = pad_ragged([_to_np(k) for k in data["kv_compact_list"]],
                           lens=[int(l) for l in data["lens_list"]], max_len=max_len)
    return {"prompts": list(data["prompts"]), "text_emb": emb, "text_mask": mask}


def load_infinity_cache(path: str, max_len: int = 0) -> Dict[str, Any]:
    """An Infinity cache → ``{"prompts", "text_emb", "text_mask"}``."""
    return call_with_retry(_read_infinity_cache, (path, max_len), site="prompt_cache")


def save_infinity_cache(path: str, prompts: Sequence[str], text_emb: np.ndarray, text_mask: np.ndarray) -> None:
    """Write the ``.npz`` form of an Infinity cache (parent directories made)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, prompts=np.asarray(list(prompts), dtype=object),
             text_emb=np.asarray(text_emb, np.float32), text_mask=np.asarray(text_mask, bool))


def cache_backend_key(backend: str) -> str:
    """A backend name → its cache format: ``sana_*`` → ``sana``; ``zimage``
    and ``infinity`` as they are. Others (``var`` is class-conditional)
    raise naming the formats."""
    key = str(backend).lower()
    if key.startswith("sana"):
        key = "sana"
    if key not in _CACHE_KINDS:
        raise ValueError(
            f"no prompt-cache format for backend {backend!r} (have: {sorted(_CACHE_KINDS)}; "
            "'var' is class-conditional and takes no encoded-prompt cache)"
        )
    return key


def file_sha256(path: str) -> str:
    """sha256 hex digest of a file's bytes: the cache's content identity."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def load_cache(path: str, backend: str, max_len: int = 0) -> Dict[str, Any]:
    """An encoded-prompt cache by backend family: the format's payload plus
    ``content_sha256`` (the file's digest) and ``cache_backend`` (the
    format key), from the warm memo when the same bytes were loaded before
    (``prompt_cache_warm_hits`` counts those)."""
    key = cache_backend_key(backend)
    sha = file_sha256(path)
    memo_key = (key, sha, int(max_len))
    hit = _WARM_CACHES.get(memo_key)
    if hit is not None:
        try:
            from ..obs.metrics import get_registry

            get_registry().inc("prompt_cache_warm_hits")
        except Exception:
            pass
        return hit
    readers = {"sana": lambda: load_sana_cache(path), "zimage": lambda: load_zimage_cache(path, max_len),
               "infinity": lambda: load_infinity_cache(path, max_len)}
    data = dict(readers[key]())
    data["content_sha256"] = sha
    data["cache_backend"] = key
    _WARM_CACHES[memo_key] = data
    return data


def load_partiprompts_tsv(path: str, column: str = "Prompt") -> List[str]:
    """The non-empty ``column`` cells of a PartiPrompts-style TSV
    (Prompt/Category/Challenge header), in row order: the order
    ``evaluate.score_folder`` joins images against."""
    import csv

    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    return [r[column] for r in rows if r.get(column, "").strip()]
