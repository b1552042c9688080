"""GGUF single-file checkpoints: the container of the reference's quantized
Z-Image transformer (port of ``hyperscalees_t2i_tpu/weights/gguf.py``,
numpy and the standard library only).

A GGUF file (ggml/llama.cpp, versions 2 and 3) is a little-endian header, a
typed metadata section, a tensor-info table (name, dims, ggml type, data
offset) and an aligned data section. The tensor types read are F32, F16 and
Q8_0 (blocks of 32 values: one f16 scale and 32 int8 quants, 34 bytes).

- :func:`load_gguf_state_dict` — every tensor dequantized to f32, keyed by
  name, in torch layout (the numpy shape is the reversed ggml ``ne``):
  what ``weights/zimage.py``'s converters take; ``weights/io.load_state_dict``
  routes ``.gguf`` paths here.
- :func:`q8_kernel_node` — a 2D Q8_0 tensor's int8 payload as an
  ``ops/quant.py`` node: ``q8 [din, dout]`` int8 with block scales ``[din/32,
  dout]`` (``dequantize_kernel`` takes the block form), every int8 value and
  f16 scale kept.
- :func:`write_gguf` — a minimal F32/F16/Q8_0 writer, for tests and small
  checkpoints.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

MAGIC = b"GGUF"
SUPPORTED_VERSIONS = (2, 3)
DEFAULT_ALIGNMENT = 32

# ggml tensor types (ggml.h): only the ones the Z-Image GGUFs ship
GGML_F32 = 0
GGML_F16 = 1
GGML_Q8_0 = 8
TYPE_NAMES = {GGML_F32: "F32", GGML_F16: "F16", GGML_Q8_0: "Q8_0"}

Q8_0_BLOCK = 32
Q8_0_BLOCK_BYTES = 2 + Q8_0_BLOCK  # f16 scale + 32 int8

# metadata value types (gguf spec)
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 = range(13)
_SCALAR_FMT = {
    _U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I", _I32: "<i",
    _F32: "<f", _BOOL: "<B", _U64: "<Q", _I64: "<q", _F64: "<d",
}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError(
                f"truncated GGUF: wanted {n} bytes at {self.pos}, "
                f"file has {len(self.buf)}"
            )
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def scalar(self, fmt: str):
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v

    def string(self) -> str:
        n = self.scalar("<Q")
        return self.take(n).decode("utf-8")

    def value(self, vtype: int):
        if vtype == _STR:
            return self.string()
        if vtype == _ARR:
            etype = self.scalar("<I")
            count = self.scalar("<Q")
            return [self.value(etype) for _ in range(count)]
        if vtype in _SCALAR_FMT:
            v = self.scalar(_SCALAR_FMT[vtype])
            return bool(v) if vtype == _BOOL else v
        raise ValueError(f"unknown GGUF metadata value type {vtype}")


@dataclasses.dataclass
class GGUFTensor:
    """One tensor's info + raw data slice.

    ``shape`` is the numpy/torch-layout shape (reversed ggml ``ne``);
    ``ne`` keeps the on-disk order (``ne[0]`` innermost/contiguous)."""

    name: str
    ne: Tuple[int, ...]
    ggml_type: int
    data: bytes

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(reversed(self.ne))

    @property
    def size(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n

    def to_f32(self) -> np.ndarray:
        """Dequantize to f32 in torch layout — exact ggml semantics
        (Q8_0: ``q · f32(d_f16)`` per 32-block along ``ne[0]``)."""
        if self.ggml_type == GGML_F32:
            return np.frombuffer(self.data, "<f4", self.size).reshape(self.shape).copy()
        if self.ggml_type == GGML_F16:
            arr = np.frombuffer(self.data, "<f2", self.size)
            return arr.astype(np.float32).reshape(self.shape)
        if self.ggml_type == GGML_Q8_0:
            q, d = _q8_0_blocks(self)
            vals = q.astype(np.float32) * d[:, None].astype(np.float32)
            return vals.reshape(self.shape)
        raise ValueError(
            f"unsupported GGML tensor type {self.ggml_type} for {self.name!r} "
            f"(supported: {sorted(TYPE_NAMES.values())})"
        )


def _q8_0_blocks(t: GGUFTensor) -> Tuple[np.ndarray, np.ndarray]:
    """Raw Q8_0 payload: ``(q int8 [n_blocks, 32], d f16 [n_blocks])``."""
    if t.size % Q8_0_BLOCK:
        raise ValueError(
            f"Q8_0 tensor {t.name!r} has {t.size} elements, not a multiple "
            f"of the block size {Q8_0_BLOCK}"
        )
    n_blocks = t.size // Q8_0_BLOCK
    raw = np.frombuffer(
        t.data, dtype=np.dtype([("d", "<f2"), ("qs", "i1", (Q8_0_BLOCK,))]),
        count=n_blocks,
    )
    return raw["qs"], raw["d"]


def _tensor_nbytes(ggml_type: int, size: int) -> int:
    if ggml_type == GGML_F32:
        return 4 * size
    if ggml_type == GGML_F16:
        return 2 * size
    if ggml_type == GGML_Q8_0:
        return (size // Q8_0_BLOCK) * Q8_0_BLOCK_BYTES
    raise ValueError(f"unsupported GGML tensor type {ggml_type}")


def read_gguf(path) -> Tuple[Dict[str, Any], Dict[str, GGUFTensor]]:
    """Parse a GGUF file → ``(metadata, {name: GGUFTensor})``.

    Every tensor's raw bytes are sliced out of the (aligned) data section;
    nothing is dequantized yet. Unknown *tensor* types parse fine here and
    only fail if dequantized; unknown metadata value types raise (the KV
    stream cannot be skipped without understanding it)."""
    buf = Path(path).read_bytes()
    r = _Reader(buf)
    if r.take(4) != MAGIC:
        raise ValueError(f"{path}: not a GGUF file (bad magic)")
    version = r.scalar("<I")
    if version not in SUPPORTED_VERSIONS:
        raise ValueError(f"{path}: GGUF version {version} unsupported "
                         f"(supported: {SUPPORTED_VERSIONS})")
    n_tensors = r.scalar("<Q")
    n_kv = r.scalar("<Q")
    metadata: Dict[str, Any] = {}
    for _ in range(n_kv):
        key = r.string()
        vtype = r.scalar("<I")
        metadata[key] = r.value(vtype)
    infos = []
    for _ in range(n_tensors):
        name = r.string()
        n_dims = r.scalar("<I")
        ne = tuple(r.scalar("<Q") for _ in range(n_dims))
        ggml_type = r.scalar("<I")
        offset = r.scalar("<Q")
        infos.append((name, ne, ggml_type, offset))
    align = int(metadata.get("general.alignment", DEFAULT_ALIGNMENT))
    data_start = r.pos + (-r.pos) % align
    tensors: Dict[str, GGUFTensor] = {}
    for name, ne, ggml_type, offset in infos:
        size = 1
        for d in ne:
            size *= d
        nbytes = _tensor_nbytes(ggml_type, size) if ggml_type in TYPE_NAMES else None
        lo = data_start + offset
        if nbytes is None:
            raise ValueError(
                f"{path}: tensor {name!r} has unsupported GGML type "
                f"{ggml_type} (supported: {sorted(TYPE_NAMES.values())})"
            )
        if lo + nbytes > len(buf):
            raise ValueError(f"{path}: tensor {name!r} data out of bounds")
        tensors[name] = GGUFTensor(name, ne, ggml_type, buf[lo : lo + nbytes])
    return metadata, tensors


def load_gguf_state_dict(path) -> Dict[str, np.ndarray]:
    """GGUF file → ``{name: f32 ndarray}`` in torch layout — the drop-in
    state dict for the weight converters (``weights/zimage.py``). Quantized
    tensors are dequantized exactly per ggml semantics; for the
    bit-preserving int8 path use :func:`q8_kernel_node` on the tensors from
    :func:`read_gguf` instead."""
    _, tensors = read_gguf(path)
    return {name: t.to_f32() for name, t in tensors.items()}


def q8_kernel_node(t: GGUFTensor) -> Dict[str, np.ndarray]:
    """A 2D Q8_0 tensor's exact int8 payload as an ``ops/quant.py`` node.

    A torch ``Linear`` weight ``[out, in]`` is stored with ``ne = (in, out)``
    and Q8_0 blocks along ``in``; our dense kernels are ``[din, dout]``
    (the transpose). Returns ``{"q8": int8 [din, dout], "scale": f32
    [din/32, dout]}`` — the block-scale form ``dequantize_kernel`` applies
    natively, preserving every int8 value and f16 scale bit-for-bit (no
    requantization, unlike the f32 round trip + ``quantize_tree``)."""
    if t.ggml_type != GGML_Q8_0:
        raise ValueError(f"{t.name!r} is {TYPE_NAMES.get(t.ggml_type, t.ggml_type)}, "
                         "not Q8_0")
    if len(t.ne) != 2:
        raise ValueError(f"{t.name!r} has ne={t.ne}; q8_kernel_node handles "
                         "2D (Linear) tensors only")
    din, dout = t.ne  # ne[0]=in (contiguous), ne[1]=out
    q, d = _q8_0_blocks(t)
    nb = din // Q8_0_BLOCK
    # [dout, nb, 32] on disk → kernel [din, dout], scales [nb, dout]
    q8 = q.reshape(dout, din).T.copy()
    scale = d.reshape(dout, nb).T.astype(np.float32).copy()
    return {"q8": q8, "scale": scale}


# ---------------------------------------------------------------------------
# minimal writer (tests + small-checkpoint packaging)
# ---------------------------------------------------------------------------


def quantize_q8_0(arr: np.ndarray) -> bytes:
    """f32 array (torch layout) → raw Q8_0 block stream (ggml semantics:
    per-32-block ``d = amax/127`` stored f16, ``q = round(x/d)``)."""
    flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    if flat.size % Q8_0_BLOCK:
        raise ValueError(
            f"Q8_0 needs a multiple of {Q8_0_BLOCK} elements, got {flat.size}"
        )
    blocks = flat.reshape(-1, Q8_0_BLOCK)
    amax = np.abs(blocks).max(axis=1)
    d = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    # round-trip through f16 BEFORE quantizing, like ggml: the stored scale
    # is f16, so q must be computed against the value the reader will use
    d16 = d.astype(np.float16)
    q = np.clip(
        np.round(blocks / d16.astype(np.float32)[:, None]), -127, 127
    ).astype(np.int8)
    out = np.zeros(blocks.shape[0], dtype=np.dtype(
        [("d", "<f2"), ("qs", "i1", (Q8_0_BLOCK,))]
    ))
    out["d"] = d16
    out["qs"] = q
    return out.tobytes()


def _w_string(parts, s: str) -> None:
    b = s.encode("utf-8")
    parts.append(struct.pack("<Q", len(b)))
    parts.append(b)


def _w_value(parts, v: Any) -> None:
    if isinstance(v, bool):
        parts.append(struct.pack("<I", _BOOL))
        parts.append(struct.pack("<B", int(v)))
    elif isinstance(v, int):
        parts.append(struct.pack("<I", _U32 if 0 <= v < 2**32 else _I64))
        parts.append(struct.pack("<I" if 0 <= v < 2**32 else "<q", v))
    elif isinstance(v, float):
        parts.append(struct.pack("<I", _F32))
        parts.append(struct.pack("<f", v))
    elif isinstance(v, str):
        parts.append(struct.pack("<I", _STR))
        _w_string(parts, v)
    else:
        raise TypeError(f"unsupported metadata value {v!r}")


def write_gguf(
    path,
    tensors: Dict[str, np.ndarray],
    metadata: Optional[Dict[str, Any]] = None,
    tensor_types: Optional[Dict[str, str]] = None,
    alignment: int = DEFAULT_ALIGNMENT,
) -> None:
    """Write a GGUF v3 file. ``tensors`` are torch-layout ndarrays;
    ``tensor_types`` maps names to ``"f32"`` (default), ``"f16"`` or
    ``"q8_0"``. Minimal by design — enough for synthetic round-trip tests
    and packaging small checkpoints."""
    tensor_types = tensor_types or {}
    meta = {"general.alignment": alignment, **(metadata or {})}
    parts: list = [MAGIC, struct.pack("<I", 3),
                   struct.pack("<Q", len(tensors)), struct.pack("<Q", len(meta))]
    for k, v in meta.items():
        _w_string(parts, k)
        _w_value(parts, v)
    payloads: Dict[str, Tuple[int, bytes]] = {}
    for name, arr in tensors.items():
        kind = tensor_types.get(name, "f32").lower()
        if kind == "f32":
            payloads[name] = (GGML_F32, np.ascontiguousarray(arr, np.float32).tobytes())
        elif kind == "f16":
            payloads[name] = (GGML_F16, np.ascontiguousarray(arr, np.float16).tobytes())
        elif kind == "q8_0":
            payloads[name] = (GGML_Q8_0, quantize_q8_0(np.asarray(arr)))
        else:
            raise ValueError(f"unsupported tensor_types[{name!r}] = {kind!r}")
    offset = 0
    infos: Dict[str, int] = {}
    for name, arr in tensors.items():
        ggml_type, data = payloads[name]
        ne = tuple(reversed(np.asarray(arr).shape))
        _w_string(parts, name)
        parts.append(struct.pack("<I", len(ne)))
        for d in ne:
            parts.append(struct.pack("<Q", int(d)))
        parts.append(struct.pack("<I", ggml_type))
        parts.append(struct.pack("<Q", offset))
        infos[name] = offset
        offset += len(data) + (-len(data)) % alignment
    head = b"".join(parts)
    pad = (-len(head)) % alignment
    chunks = [head, b"\x00" * pad]
    for name in tensors:
        _, data = payloads[name]
        chunks.append(data)
        chunks.append(b"\x00" * ((-len(data)) % alignment))
    Path(path).write_bytes(b"".join(chunks))
