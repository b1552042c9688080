"""Host-side image utilities: uint8 conversion, per-prompt strips, PNG files
and a Lanczos resize (port of ``hyperscalees_t2i_tpu/utils/images.py``).

Images stay ``[H, W, 3]`` numpy arrays until an artifact is written. The
reference builds its strips with Pillow; this module needs numpy and the
standard library only:

- :func:`resize_lanczos` and :func:`resize_bicubic` are Pillow's
  ``Image.resize(size, Image.LANCZOS)`` and ``Image.BICUBIC`` for 8-bit
  images: a separable filter (Lanczos-3, or the cubic convolution with a =
  −0.5 and support 2) whose support widens by the downscale factor,
  coefficients normalized per output pixel and rounded to 22-bit fixed
  point, the horizontal pass first into uint8, then the vertical pass, each
  sum rounded and clipped as Pillow does;
- :func:`write_png` writes 8-bit RGB with filter 0 through ``zlib``;
  :func:`read_png` reads 8-bit PNGs of every colour type and row filter as
  Pillow's ``Image.open(path).convert("RGB")`` does.

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


def _bicubic(x: float) -> float:
    """Pillow's ``bicubic_filter``: cubic convolution with a = −0.5."""
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


# filter name → (kernel, support at scale 1), Pillow's filter table
_FILTERS = {"lanczos": (_lanczos, 3.0), "bicubic": (_bicubic, 2.0)}


@functools.lru_cache(maxsize=16)
def _coefficients(in_size: int, out_size: int, filt: str = "lanczos") -> np.ndarray:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for
    ``filt`` as a dense ``[out_size, in_size]`` matrix of fixed-point
    weights (zero outside each output's window); cached, read-only."""
    kernel, base_support = _FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ss = 1.0 / filterscale
    out = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [kernel((x + xmin - center + 0.5) * ss) for x in range(xmax)]
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
    uint8, one float64 matrix product over the resampled axis. Every
    product and partial sum is an integer below 2**53, so the sums are exact
    in any order; the rounding half is added, the sum shifted right by the
    precision and clipped to [0, 255] (Pillow's ``clip8``), all exactly in
    float64."""
    a, n, c = img.shape
    src = np.ascontiguousarray(img.transpose(1, 0, 2)).reshape(n, a * c).astype(np.float64)
    acc = coeffs @ src
    acc += float(1 << (_PRECISION_BITS - 1))
    acc *= 2.0 ** -_PRECISION_BITS
    out = np.clip(np.floor(acc, out=acc), 0.0, 255.0, out=acc).astype(np.uint8)
    return out.reshape(-1, a, c).transpose(1, 0, 2)


def _resize(img: np.ndarray, size: Tuple[int, int], filt: str) -> np.ndarray:
    arr = to_uint8(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    width, height = int(size[0]), int(size[1])
    h, w = arr.shape[:2]
    if w != width:
        arr = _pass(arr, _coefficients(w, width, filt))
    if h != height:
        arr = _pass(arr.transpose(1, 0, 2), _coefficients(h, height, filt)).transpose(1, 0, 2)
    return np.ascontiguousarray(arr)


def resize_lanczos(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``[H, W, C]`` uint8 → ``[size[1], size[0], C]`` uint8 (``size`` is
    ``(width, height)``, as Pillow takes it), Pillow's LANCZOS resample."""
    return _resize(img, size, "lanczos")


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``[H, W, C]`` uint8 → ``[size[1], size[0], C]`` uint8 (``size`` is
    ``(width, height)``), Pillow's BICUBIC resample."""
    return _resize(img, size, "bicubic")


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


# colour type → channels at 8 bits (PNG spec, IHDR)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(rows: np.ndarray, bpp: int, name: str) -> np.ndarray:
    """Undo the per-scanline filters of ``rows [H, 1 + stride]`` (filter
    byte first) → ``[H, stride]`` uint8. None, Sub and Up run vectorized;
    Average and Paeth depend on the byte to their left and run bytewise."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, cur = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            rec = cur
        elif kind == 1:
            rec = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            rec = cur + prior
        elif kind in (3, 4):
            buf = bytearray(cur.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = buf[i - bpp] if i >= bpp else 0
                if kind == 3:
                    buf[i] = (buf[i] + ((a + up[i]) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    buf[i] = (buf[i] + _paeth(a, up[i], c)) & 0xFF
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{name}: PNG row {y} has filter type {kind}")
        out[y] = rec
        prior = out[y]
    return out


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The bytes of an 8-bit PNG → ``[H, W, 3]`` uint8, as Pillow's
    ``Image.open(...).convert("RGB")`` gives it: grey replicated, palette
    expanded (entries the ``PLTE`` chunk lacks read as grey ``(i, i, i)``,
    Pillow's default palette), alpha dropped. Several ``IDAT`` chunks, all
    five row filters and 1-, 2- and 4-bit grey and palette files (Pillow
    writes a palette of few colours so) are read; 16-bit files, interlaced
    files,
    non-PNG data and chunks whose CRC does not match raise ``ValueError``
    naming ``name``."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: broken PNG chunk {kind!r} (CRC mismatch)")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, color, _comp, _filt, interlace = header
    packed = color in (0, 3) and depth in (1, 2, 4)
    if color not in _PNG_CHANNELS or not (depth == 8 or packed):
        raise ValueError(f"{name}: PNG bit depth {depth}, colour type {color}; only 8-bit grey, RGB, "
                         "palette, grey+alpha and RGBA (and 1-4-bit grey and palette) are read")
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not read")
    ch = _PNG_CHANNELS[color]
    stride = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + stride):
        raise ValueError(f"{name}: PNG image data is {raw.size} bytes, {h * (1 + stride)} expected")
    rows = _unfilter(raw[:h * (1 + stride)].reshape(h, 1 + stride), max(ch * depth // 8, 1), name)
    if packed:  # samples packed high bit first; grey scales to 0..255 as Pillow's "1", "L;2", "L;4"
        bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
        pix = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)[:, :, None]
        if color == 0:
            pix = pix * np.uint8(255 // ((1 << depth) - 1))
    else:
        pix = rows.reshape(h, w, ch)
    if color == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        table[:len(palette)] = palette[:256]
        return table[pix[:, :, 0]]
    if color in (0, 4):
        return np.repeat(pix[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pix[:, :, :3])


def read_png(path) -> np.ndarray:
    """The PNG at ``path`` → ``[H, W, 3]`` uint8 (:func:`decode_png`). A
    ``.jpg``/``.jpeg`` file raises: the port has no JPEG decoder."""
    path = Path(path)
    if path.suffix.lower() in (".jpg", ".jpeg"):
        raise ValueError(f"{path}: JPEG is not read (no JPEG decoder without Pillow); write PNG files")
    return decode_png(path.read_bytes(), str(path))
