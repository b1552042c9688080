"""Checkpoint ingestion: raw state dicts → numpy (port of
``hyperscalees_t2i_tpu/weights/io.py``).

A checkpoint is a flat ``{name: ndarray}`` mapping that the per-model
converters (``weights/var.py``, ``weights/sana.py``, ``weights/infinity.py``)
reshape into the JAX package's trees. Supported:

- torch ``.pt``/``.pth``/``.bin`` pickles (``torch.load`` on the CPU with
  ``weights_only``; a ``state_dict``, ``model`` or ``module`` wrapper is
  unwrapped);
- ``.safetensors`` files, read by this module's own parser (no
  ``safetensors`` package is needed): an 8-byte little-endian header
  length, a JSON header of each tensor's dtype, shape and byte offsets,
  then the raw bytes. F32, F64, F16, BF16, I8, U8, I16, I32, I64 and BOOL
  tensors are read;
- directories: every ``*.safetensors`` shard merged (the Hugging Face
  sharded layout; ``*.index.json`` is not needed, shards describe
  themselves), else the ``*.pth``, ``*.pt`` or ``*.bin`` files inside.

bf16 and f16 tensors come out as f32 on both routes (numpy has no
bfloat16). The JAX reference reads safetensors through the
``safetensors`` package's numpy route, which keeps f16 and raises
``TypeError`` on bf16; the converters cast every tensor to f32, so the
trees are the same wherever the reference reads the file. ``.gguf`` files
are ROADMAP queue A item 9 (Z-Image) and raise.

:func:`save_safetensors` writes the same format, streaming tensors that are
made while the file is written.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np

from ..resilience.retry import retry

StateDict = Dict[str, np.ndarray]

# safetensors dtype code → (numpy storage dtype, f32 upcast of a 16-bit float)
_ST_DTYPES: Dict[str, Tuple[np.dtype, bool]] = {
    "F64": (np.dtype("<f8"), False), "F32": (np.dtype("<f4"), False), "F16": (np.dtype("<f2"), True),
    "BF16": (np.dtype("<u2"), True), "I64": (np.dtype("<i8"), False), "I32": (np.dtype("<i4"), False),
    "I16": (np.dtype("<i2"), False), "I8": (np.dtype("i1"), False), "U8": (np.dtype("u1"), False),
    "BOOL": (np.dtype("?"), False),
}
_NP_CODES = {np.dtype(np.float64): "F64", np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
             np.dtype(np.int64): "I64", np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
             np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8", np.dtype(np.bool_): "BOOL"}


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (``uint16``) → the f32 values they encode."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 → bfloat16 bit patterns (``uint16``), rounded to nearest even as
    ``torch.Tensor.to(torch.bfloat16)`` rounds (NaN kept quiet)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        r[nan] = ((u[nan] >> 16) | np.uint32(0x40)).astype(np.uint16)
    return r


def _to_numpy(t: Any) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    t = t.detach().cpu()
    if str(t.dtype) in ("torch.bfloat16", "torch.float16"):
        t = t.float()
    return t.numpy()


def _load_torch(path: Path) -> StateDict:
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for k in ("state_dict", "model", "module"):  # the common checkpoint wrappers
            if k in obj and isinstance(obj[k], dict):
                obj = obj[k]
                break
    return {k: _to_numpy(v) for k, v in obj.items() if hasattr(v, "shape")}


def read_safetensors_header(path) -> Tuple[Dict[str, Any], int]:
    """``(header, data_start)``: the JSON header (``__metadata__``
    included) and the byte offset of the data buffer."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than its 8-byte header length)")
        (n,) = struct.unpack("<Q", head)
        raw = f.read(n)
    if len(raw) != n:
        raise ValueError(f"{path}: truncated safetensors header ({len(raw)} of {n} bytes)")
    return json.loads(raw.decode("utf-8")), 8 + n


def _load_safetensors(path: Path) -> StateDict:
    header, start = read_safetensors_header(path)
    size = path.stat().st_size
    out: StateDict = {}
    with open(path, "rb") as f:
        for name, info in header.items():
            if name == "__metadata__":
                continue
            code = info["dtype"]
            if code not in _ST_DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {code}, which this reader does not read")
            dt, upcast = _ST_DTYPES[code]
            shape = tuple(int(s) for s in info["shape"])
            lo, hi = (int(o) for o in info["data_offsets"])
            count = int(np.prod(shape, dtype=np.int64))
            if hi - lo != count * dt.itemsize or start + hi > size:
                raise ValueError(f"{path}: tensor {name!r} spans bytes [{lo}, {hi}) of the data buffer, which "
                                 f"does not hold {code}{list(shape)}")
            f.seek(start + lo)
            a = np.fromfile(f, dtype=dt, count=count).reshape(shape)
            if upcast:
                a = bf16_bits_to_f32(a) if code == "BF16" else a.astype(np.float32)
            out[name] = a
    return out


TensorSpec = Union[np.ndarray, Any, Tuple[str, Tuple[int, ...], Callable[[], Any]]]


def _bytes_of(value: Any, code: str) -> bytes:
    if hasattr(value, "detach"):  # a torch tensor
        t = value.detach().cpu().contiguous()
        if str(t.dtype) == "torch.bfloat16":
            import torch

            return t.view(torch.int16).numpy().tobytes()
        value = t.numpy()
    a = np.asarray(value)
    if code == "BF16" and a.dtype != np.uint16:
        a = f32_to_bf16_bits(a)
    return np.ascontiguousarray(a, dtype=_ST_DTYPES[code][0]).tobytes()


def _code_of(value: Any) -> str:
    if hasattr(value, "detach"):
        name = str(value.dtype).replace("torch.", "")
        return {"bfloat16": "BF16", "float16": "F16"}.get(name) or _NP_CODES[np.dtype(name)]
    return _NP_CODES[np.asarray(value).dtype]


def save_safetensors(path, tensors: Mapping[str, TensorSpec], metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` as a ``.safetensors`` file; returns its size in
    bytes. A value is a numpy array, a torch tensor (bf16 included), or a
    ``(dtype code, shape, make)`` triple whose ``make()`` returns the array
    (f32 values for ``"BF16"``, rounded to nearest even) when its bytes are
    written, so a file larger than the host's memory can be made tensor by
    tensor."""
    specs = []
    for name, v in tensors.items():
        if isinstance(v, tuple):
            code, shape, make = v
        else:
            code, shape, make = _code_of(v), tuple(v.shape), (lambda v=v: v)
        specs.append((name, code, tuple(int(s) for s in shape), make))
    header: Dict[str, Any] = {"__metadata__": dict(metadata)} if metadata else {}
    off = 0
    for name, code, shape, _ in specs:
        n = int(np.prod(shape, dtype=np.int64)) * _ST_DTYPES[code][0].itemsize
        header[name] = {"dtype": code, "shape": list(shape), "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)  # the data buffer starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, code, shape, make in specs:
            data = _bytes_of(make(), code)
            if len(data) != header[name]["data_offsets"][1] - header[name]["data_offsets"][0]:
                raise ValueError(f"tensor {name!r}: made {len(data)} bytes, declared {code}{list(shape)}")
            f.write(data)
    return 8 + len(raw) + off


@retry(site="weights")
def load_state_dict(path) -> StateDict:
    """Load a checkpoint file or directory into ``{name: ndarray}``.

    Retried with bounded backoff (``resilience/retry.py``): a multi-GB read
    off a network file system is the longest host I/O of a run. A missing
    path fails at once."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"no checkpoint at {p}")
    if p.is_dir():
        shards = sorted(p.glob("*.safetensors"))
        if shards:
            out: StateDict = {}
            for s in shards:
                out.update(_load_safetensors(s))
            return out
        for pat in ("*.pth", "*.pt", "*.bin"):
            files = sorted(p.glob(pat))
            if files:
                out = {}
                for f in files:
                    out.update(_load_torch(f))
                return out
        raise FileNotFoundError(f"no checkpoint files under {p}")
    if p.suffix == ".safetensors":
        return _load_safetensors(p)
    if p.suffix == ".gguf":
        raise NotImplementedError(f"{p}: GGUF checkpoints (the Z-Image transformer's container) are not ported yet "
                                  "(ROADMAP queue A item 9)")
    return _load_torch(p)


def strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    """Drop a uniform ``prefix.`` from every key (e.g. ``model.``)."""
    pl = prefix if prefix.endswith(".") else prefix + "."
    if all(k.startswith(pl) for k in sd):
        return {k[len(pl):]: v for k, v in sd.items()}
    return sd
