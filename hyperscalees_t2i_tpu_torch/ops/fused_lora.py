"""The perturbed-LoRA chain ``scale·(x@a_k)@b_k`` and its CUDA kernel (K2).

Port of ``hyperscalees_t2i_tpu/ops/fused_lora.py``. There the Pallas kernel
``_chain_kernel`` runs the four thin products of one member's factored
adapter leaf on a VMEM-resident token tile. Here the kernel is
``csrc/lora_chain.cu`` (its note says what bounds it and how it is tiled),
built by ``nvcc`` at first use and called through ``ctypes`` on PyTorch's
current stream. It serves the LoRA delta of every float base site whose
adapter leaf carries both factors as ``lora.FactoredDelta`` (ES training
with ``pop_fuse`` over a float base).

- :func:`member_lora_delta` — the wrapper. A CPU tensor takes the plain
  version :func:`member_lora_delta_reference`; a CUDA tensor launches the
  kernel or raises. ``member_lora_delta.launches`` counts kernel launches.
- :func:`chain_launch_args` — the checks and the C arguments of the factors,
  shared with the fused int8 kernel K3 (``ops/fused_qlora.py``).

Member lanes: ``u``, ``v`` and ``c`` may carry a leading lane axis; ``x``'s
rows are then grouped lane-major, one equal group per lane.
"""

from __future__ import annotations

import ctypes
from typing import Any, List, Tuple

import torch

MAX_RANK = 16  # r_l and r_e limits of csrc/lora_chain.cuh
DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}

# pointers of a.w, a.u, a.v, b.w, b.u, b.v, c_a, c_b; rows per lane, lanes,
# din, dout, r_l, r_e; lane strides of a.u, a.v, b.u, b.v
CHAIN_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 4)


def _lanes(f: Any) -> int:
    return f.c.shape[0] if f.c.ndim else 0


def _laned_f32(f: Any) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(w, u [n, m, r], v [n, k, r], c [n, 1, 1])`` in f32, ``n`` = 1
    for a factor without lanes."""
    f32 = torch.float32
    u, v, c = f.u.to(f32), f.v.to(f32), f.c.to(f32)
    if not f.c.ndim:
        u, v, c = u[None], v[None], c.reshape(1)
    return f.w.to(f32), u, v, c.reshape(-1, 1, 1)


def chain_reference(x3: torch.Tensor, a: Any, b: Any) -> torch.Tensor:
    """``(x@a_k)@b_k`` in f32 as the kernels order it: ``xa = x@a.w +
    c_a·(x@a.u)@a.vᵀ``, then ``xa@b.w + c_b·(xa@b.u)@b.vᵀ``. ``x3`` is
    ``[lanes or 1, rows, din]`` f32."""
    aw, au, av, ca = _laned_f32(a)
    bw, bu, bv, cb = _laned_f32(b)
    xa = x3 @ aw + ca * ((x3 @ au) @ av.transpose(-1, -2))
    return xa @ bw + cb * ((xa @ bu) @ bv.transpose(-1, -2))


def member_lora_delta_reference(x: torch.Tensor, a: Any, b: Any, scale: float) -> torch.Tensor:
    """Plain version: the f32 chain, times ``scale``, cast to x's dtype."""
    n = max(_lanes(a), 1)
    x3 = x.reshape(n, -1, x.shape[-1]).to(torch.float32)
    y = chain_reference(x3, a, b) * scale
    return y.reshape(*x.shape[:-1], b.w.shape[-1]).to(x.dtype)


def _lane_strided(t: torch.Tensor, lanes: int, shape: Tuple[int, int], what: str) -> Tuple[torch.Tensor, int]:
    """``t`` as ``[m, r]`` or ``[lanes, m, r]`` with each lane's matrix
    contiguous, and its lane stride in elements."""
    want = tuple(shape) if not lanes else (lanes, *shape)
    if tuple(t.shape) != want:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {want}")
    if t.stride(-1) != 1 or t.stride(-2) != shape[1]:
        t = t.contiguous()
    return t, (t.stride(0) if lanes else 0)


def chain_launch_args(x: torch.Tensor, a: Any, b: Any, rows: int) -> Tuple[List[Any], torch.dtype, List[Any]]:
    """Check the factors of one chain against ``x`` (on CUDA) and return
    ``(C arguments, noise dtype, tensors to keep alive)``. Raises on
    anything the kernels do not take."""
    from ..lora import FactoredDelta

    if not (isinstance(a, FactoredDelta) and isinstance(b, FactoredDelta)):
        raise TypeError("the chain kernels take lora.FactoredDelta factors for both a and b")
    if a.w.ndim != 2 or b.w.ndim != 2:
        raise ValueError(f"the chain kernels take 2D factors, got a.w {tuple(a.w.shape)}, b.w {tuple(b.w.shape)}")
    din, r_l = a.w.shape
    dout = b.w.shape[1]
    r_e = a.u.shape[-1]
    if b.w.shape[0] != r_l or x.shape[-1] != din:
        raise ValueError(f"x [.., {x.shape[-1]}], a.w {tuple(a.w.shape)} and b.w {tuple(b.w.shape)} do not chain")
    if not (1 <= r_l <= MAX_RANK and 1 <= r_e <= MAX_RANK):
        raise ValueError(f"the chain kernels take ranks 1..{MAX_RANK}, got r_l={r_l}, r_e={r_e}")
    lanes = _lanes(a)
    if _lanes(b) != lanes:
        raise ValueError(f"a carries {lanes} lanes, b {_lanes(b)}")
    if rows % max(lanes, 1):
        raise ValueError(f"{rows} rows do not split into {lanes} lanes")
    ndt = a.u.dtype
    if ndt not in DTYPE_NAMES or any(t.dtype != ndt for t in (a.v, b.u, b.v)):
        raise TypeError(f"noise factors must all be bf16 or all f32, got "
                        f"{[t.dtype for t in (a.u, a.v, b.u, b.v)]}")
    tensors = [a.w, a.u, a.v, a.c, b.w, b.u, b.v, b.c]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"x and the factors lie on different devices: {x.device}, "
                         f"{sorted({str(t.device) for t in tensors})}")
    aw = a.w.to(torch.float32).contiguous()
    bw = b.w.to(torch.float32).contiguous()
    au, au_ls = _lane_strided(a.u, lanes, (din, r_e), "a.u")
    av, av_ls = _lane_strided(a.v, lanes, (r_l, r_e), "a.v")
    bu, bu_ls = _lane_strided(b.u, lanes, (r_l, r_e), "b.u")
    bv, bv_ls = _lane_strided(b.v, lanes, (dout, r_e), "b.v")
    ca = a.c.to(torch.float32).reshape(-1).contiguous()
    cb = b.c.to(torch.float32).reshape(-1).contiguous()
    n = max(lanes, 1)
    if ca.numel() != n or cb.numel() != n:
        raise ValueError(f"c_a and c_b must hold one coefficient per lane ({n})")
    keep = [aw, au, av, bw, bu, bv, ca, cb]
    args = [t.data_ptr() for t in keep] + [rows // n, n, din, dout, r_l, r_e, au_ls, av_ls, bu_ls, bv_ls]
    return args, ndt, keep


def member_lora_delta(x: torch.Tensor, a: Any, b: Any, scale: float) -> torch.Tensor:
    """``scale·(x@a_k)@b_k`` for one member's (or a lane group's) factored
    2D adapter leaf. ``x``: ``[..., din]`` bf16 or f32; ``a.w [din, r_l]``,
    ``b.w [r_l, dout]``; returns ``[..., dout]`` in x's dtype. On the CPU
    this is the plain version; on CUDA the kernel runs on the current
    stream, and anything it does not take raises."""
    if x.device.type == "cpu":
        return member_lora_delta_reference(x, a, b, scale)
    if x.device.type != "cuda":
        raise ValueError(f"member_lora_delta runs on cuda or cpu tensors, got {x.device}")
    if x.dtype not in DTYPE_NAMES:
        raise TypeError(f"member_lora_delta takes bf16 or f32 activations, got {x.dtype}")
    x = x.contiguous()
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    args, ndt, _keep = chain_launch_args(x, a, b, rows)
    out = torch.empty(*x.shape[:-1], b.w.shape[-1], dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    from ._build import entry

    fn = entry("lora_chain", f"hses_lora_chain_{DTYPE_NAMES[x.dtype]}_{DTYPE_NAMES[ndt]}",
               [ctypes.c_void_p] * 2 + CHAIN_ARGTYPES + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), *args, float(scale),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lora_chain kernel launch failed: cudaError {err}")
    member_lora_delta.launches += 1
    return out


member_lora_delta.launches = 0
