"""Host-side image utilities: uint8 conversion, per-prompt strips, PNG files
and a Lanczos resize (port of ``hyperscalees_t2i_tpu/utils/images.py``).

Images stay ``[H, W, 3]`` numpy arrays until an artifact is written. The
reference builds its strips with Pillow; this module needs numpy and the
standard library only:

- :func:`resize_lanczos` is Pillow's ``Image.resize(size, Image.LANCZOS)``
  for 8-bit images: a separable Lanczos-3 filter whose support widens by the
  downscale factor, coefficients normalized per output pixel and rounded to
  22-bit fixed point, the horizontal pass first into uint8, then the
  vertical pass, each sum rounded and clipped as Pillow does;
- :func:`write_png` writes 8-bit RGB with filter 0 through ``zlib``.

Where the reference returns a PIL image, these functions return the array.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed-point coefficients (Resample.c)
_LANCZOS_SUPPORT = 3.0


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[...] float in [0,1] (or uint8 passthrough) → uint8, round-half-up."""
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        return arr
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3.0)
    return 0.0


@functools.lru_cache(maxsize=16)
def _coefficients(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` as a dense
    ``[out_size, in_size]`` matrix of fixed-point weights (zero outside each
    output's window); cached, read-only."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    out = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(w)
        for x in range(xmax):
            k = w[x] / ww if ww != 0.0 else w[x]
            # C's (int) truncates toward zero
            out[xx, xmin + x] = float(int(-0.5 + k * (1 << _PRECISION_BITS)) if k < 0
                                      else int(0.5 + k * (1 << _PRECISION_BITS)))
    out.setflags(write=False)
    return out


def _pass(img: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """One pass along axis 1 of ``img [A, in, C]`` uint8 → ``[A, out, C]``
    uint8. Every product and partial sum is an integer below 2**53, so the
    float64 matmul is exact in any order; the rounding half is added, the
    sum shifted right by the precision and clipped to [0, 255] (Pillow's
    ``clip8``), all exactly in float64."""
    acc = np.einsum("aic,oi->aoc", img.astype(np.float64), coeffs, optimize=True)
    acc += float(1 << (_PRECISION_BITS - 1))
    acc *= 2.0 ** -_PRECISION_BITS
    return np.clip(np.floor(acc, out=acc), 0.0, 255.0, out=acc).astype(np.uint8)


def resize_lanczos(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``[H, W, C]`` uint8 → ``[size[1], size[0], C]`` uint8 (``size`` is
    ``(width, height)``, as Pillow takes it), Pillow's LANCZOS resample."""
    arr = to_uint8(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    width, height = int(size[0]), int(size[1])
    h, w = arr.shape[:2]
    if w != width:
        arr = _pass(arr, _coefficients(w, width))
    if h != height:
        arr = _pass(arr.transpose(1, 0, 2), _coefficients(h, height)).transpose(1, 0, 2)
    return np.ascontiguousarray(arr)


def _rgb(img: np.ndarray) -> np.ndarray:
    """``[H, W]``, ``[H, W, 1]``, ``[H, W, 3]`` or ``[H, W, 4]`` → ``[H, W, 3]``
    uint8 (Pillow's ``convert("RGB")``: gray repeated, alpha dropped)."""
    arr = to_uint8(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    return arr[:, :, :3]


def make_prompt_strip(
    images: Sequence[Optional[np.ndarray]],
    num_prompts: int,
    tile_size: int = 256,
    bg_color=(0, 0, 0),
) -> Optional[np.ndarray]:
    """Horizontal strip of per-prompt tiles, ``[tile, tile · num_prompts, 3]``
    uint8 (reference ``make_prompt_strip``); ``None`` for no prompts."""
    if num_prompts <= 0:
        return None
    strip = np.empty((tile_size, tile_size * num_prompts, 3), np.uint8)
    strip[:] = np.asarray(bg_color, np.uint8)
    for i in range(num_prompts):
        if i < len(images) and images[i] is not None:
            strip[:, i * tile_size:(i + 1) * tile_size] = resize_lanczos(_rgb(images[i]), (tile_size, tile_size))
    return strip


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray) -> bytes:
    """``[H, W, 3]`` (uint8, or float in [0, 1]) → the bytes of an 8-bit RGB
    PNG, every row filter 0, one zlib stream."""
    arr = np.ascontiguousarray(_rgb(img))
    h, w = arr.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> Path:
    """Write ``img`` as a PNG at ``path`` (parents made); returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(img))
    return path


def save_image(img: Optional[np.ndarray], path) -> None:
    """Write one image as a PNG; ``None`` writes nothing."""
    if img is None:
        return
    write_png(path, img)
