"""Deterministic text→seed and (seed, index)→seed hashing.

Python's builtin ``hash(str)`` is salted per interpreter (PYTHONHASHSEED), so
sha256 is used: the same prompt or request gives the same numbers in every
process.
"""

from __future__ import annotations

import hashlib


def stable_text_seed(text: str) -> int:
    """32-bit seed of a prompt string (same value as the JAX package's)."""
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:4], "little")


def item_seed(seed: int, item_index: int) -> int:
    """63-bit seed of one image inside a request: a function of the request
    seed and the image's position in that request only, so an image is the
    same whether its request is served alone or inside a batch."""
    h = hashlib.sha256(f"{int(seed)}:{int(item_index)}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)
