"""Deterministic text→seed hashing.

Python's builtin ``hash(str)`` is salted per interpreter (PYTHONHASHSEED), so
sha256 is used: the same prompt gives the same numbers in every process.
"""

from __future__ import annotations

import hashlib


def stable_text_seed(text: str) -> int:
    """32-bit seed of a prompt string (same value as the JAX package's)."""
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:4], "little")

