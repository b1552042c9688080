"""The perturbed-LoRA chain ``scale·(x@a_k)@b_k`` and its CUDA kernel (K2).

Port of ``hyperscalees_t2i_tpu/ops/fused_lora.py``. There the Pallas kernel
``_chain_kernel`` runs the four thin products of one member's factored
adapter leaf on a VMEM-resident token tile. Here the kernel is
``csrc/lora_chain.cu``, built by ``nvcc`` at first use and called through
``ctypes`` on PyTorch's current stream. It serves the LoRA delta of every
float base site whose adapter leaf carries both factors as
``lora.FactoredDelta`` (ES training with ``pop_fuse`` over a float base).

What bounds it: bytes in principle — a call reads x once and writes its
output once, about 12 flops a byte in bf16, 2.8 µs of HBM traffic on an
H100 at 1024×2240×2240 and under a microsecond at T ≤ 32. In practice a
call takes as long as one block's chain of dependent steps (its k walk,
then its epilogue), so the grid (:func:`_plan`) spreads each call over the
card: lanes × row tiles × column groups, one wave of 132 SMs where the
rows allow (128 blocks at 1024×2240×2240, 35 at T = 32, 130 at T = 1),
every block summing its rows' thin products over all of din itself. bf16 x
runs the thin products on the tensor cores, f32 x on the CUDA cores (the
csrc note has the design; PERF.md §6 the measured times).

Why the result is bitwise row- and lane-invariant: the order of each
output's sum over din is fixed by three numbers that no call changes:
``bk`` (64: warp-stages of four k16 mma steps; 32: FMA chunks), the warps
``W`` = 8 that split the k walk (warp w takes stages w, w + W, …) and
their ascending order when their partial sums are added (f32: chunk sums
added in ascending chunk order). The plan may follow the rows, lanes and
dout with its column group; the C entry refuses a ``bk`` or ``W`` other
than its route's own, so the order the CPU tests check is the kernel's.

- :func:`member_lora_delta` — the wrapper. A CPU tensor takes the plain
  version :func:`member_lora_delta_reference`; a CUDA tensor launches the
  kernel once or raises. ``member_lora_delta.launches`` counts kernel
  launches (not a CUDA graph's capture, whose replays run the kernel
  without the wrapper).
- :func:`_plan` — the kernel's route for one call, a pure function of the
  rows per lane, lanes, din, dout, dtype and x's address.
- :func:`chain_launch_args` — the checks and the C arguments of the factors,
  shared with the fused int8 kernel K3 (``ops/fused_qlora.py``).

Member lanes: ``u``, ``v`` and ``c`` may carry a leading lane axis; ``x``'s
rows are then grouped lane-major, one equal group per lane.
"""

from __future__ import annotations

import ctypes
from typing import Any, List, NamedTuple, Tuple

import torch

from ..obs.program_cost import kernel_cost, tensor_bytes
from .quant_mm import copy_widths

MAX_RANK = 16  # r_l and r_e limits of csrc/lora_chain.cuh
DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}

# pointers of a.w, a.u, a.v, b.w, b.u, b.v, c_a, c_b; rows per lane, lanes,
# din, dout, r_l, r_e; lane strides of a.u, a.v, b.u, b.v
CHAIN_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 4)

# Route ids of csrc/lora_chain.cu's C entries, and its fixed sum order
MMA_ROWS32, F32_ROWS8 = 0, 1
WARPS = 8          # W: warp w sums stages (chunks) w, w + W, …; partial sums added in ascending order
MAX_COLS = 1024    # widest column group of a block
_MIN_COLS = 64     # narrowest group where the columns allow
_SMS = 132         # streaming multiprocessors of an H100 SXM


class ChainPlan(NamedTuple):
    route: int  # MMA_ROWS32 (bf16 x: 32-row tiles on the tensor cores) or F32_ROWS8 (f32 x: 8-row tiles)
    rows: int   # rows of a lane per block
    cols: int   # output columns per block, a multiple of 8
    bk: int     # depth of one stage of each output's k sum: 64 (bf16), 32 (f32); the C entry refuses others
    warps: int  # W; the C entry refuses any other
    a_vec: int  # elements of bf16 x per copy (8: 16-byte, 4: 8-byte cp.async, 1: element loads); 0 for f32


def _plan(rows_per_lane: int, lanes: int, K: int, N: int, dtype: torch.dtype, x_ptr: int = 0) -> ChainPlan:
    """The kernel's route for ``lanes`` groups of ``x[rows_per_lane, K]``
    against a chain of ``N`` output columns.

    bf16: 32-row tiles; f32: 8-row tiles. The column group takes what the
    row tiles leave of one wave of the card's SMs, ``⌊132 / (lanes ·
    ⌈rows / tile⌉)⌋`` groups, rounded to a multiple of 8 columns, at least
    64 and at most 1024: 4 groups of 560 at T = 1024 (128 blocks), 35 of 64
    at T = 32, 130 of 104 at T = 1 and dout 13440. ``bk`` and ``warps`` fix
    the sum order and are the same for every call of a dtype. Copy widths
    of x as K1's (``quant_mm.copy_widths``)."""
    if dtype == torch.float32:
        route, rows, bk, a_vec = F32_ROWS8, 8, 32, 0
    elif dtype == torch.bfloat16:
        route, rows, bk = MMA_ROWS32, 32, 64
        a_vec = copy_widths(K, 0, x_ptr, 0)[0]
    else:
        raise TypeError(f"member_lora_delta takes bf16 or f32 activations, got {dtype}")
    groups = max(1, _SMS // (lanes * -(-rows_per_lane // rows)))
    cols = min(MAX_COLS, max(_MIN_COLS, 8 * -(-N // (8 * groups))))
    return ChainPlan(route, rows, cols, bk, WARPS, a_vec)


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


def _launch(x: torch.Tensor, out: torch.Tensor, args: List[Any], ndt: torch.dtype, scale: float,
            plan: ChainPlan) -> None:
    """One launch of the kernel by ``plan`` on x's device and current stream;
    ``args`` are :func:`chain_launch_args`'s."""
    from ._build import entry

    fn = entry("lora_chain", f"hses_lora_chain_{DTYPE_NAMES[x.dtype]}_{DTYPE_NAMES[ndt]}",
               [ctypes.c_void_p] * 2 + CHAIN_ARGTYPES + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), *args, float(scale), plan.route, plan.bk, plan.warps, plan.cols,
                 plan.a_vec, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lora_chain kernel launch failed: cudaError {err}")


def chain_cost(x: torch.Tensor, a: Any, b: Any) -> Tuple[int, int, int]:
    """``(FLOPs, bytes read, rows)`` of the chain ``(x@a_k)@b_k`` over all
    of x's rows as :func:`chain_reference` orders it: ``x@a.w``,
    ``x@a.u``, ``(x@a.u)@a.vᵀ``, then ``xa@b.w``, ``xa@b.u`` and
    ``(xa@b.u)@b.vᵀ``, two FLOPs a multiply-add; x and the factors read
    once."""
    din, r_l = a.w.shape[-2:]
    r_e, dout = a.u.shape[-1], b.w.shape[-1]
    rows = x.numel() // din if din else 0
    flops = 2 * rows * (din * r_l + din * r_e + r_e * r_l + r_l * dout + r_l * r_e + r_e * dout)
    return flops, tensor_bytes(x, *a, *b), rows


def member_lora_delta_cost(x: torch.Tensor, a: Any, b: Any, scale: float) -> Tuple[int, int]:
    """``(FLOPs, bytes)`` of one call: the chain's (:func:`chain_cost`), the
    output written once."""
    flops, nbytes, rows = chain_cost(x, a, b)
    return flops, nbytes + rows * b.w.shape[-1] * x.element_size()


@kernel_cost(member_lora_delta_cost)
def member_lora_delta(x: torch.Tensor, a: Any, b: Any, scale: float) -> torch.Tensor:
    """``scale·(x@a_k)@b_k`` for one member's (or a lane group's) factored
    2D adapter leaf. ``x``: ``[..., din]`` bf16 or f32; ``a.w [din, r_l]``,
    ``b.w [r_l, dout]``; returns ``[..., dout]`` in x's dtype. On the CPU
    this is the plain version; on CUDA the kernel runs once on the current
    stream, by :func:`_plan`, and anything it does not take raises."""
    if x.device.type == "cpu":
        return member_lora_delta_reference(x, a, b, scale)
    if x.device.type != "cuda":
        raise ValueError(f"member_lora_delta runs on cuda or cpu tensors, got {x.device}")
    if x.dtype not in DTYPE_NAMES:
        raise TypeError(f"member_lora_delta takes bf16 or f32 activations, got {x.dtype}")
    x = x.contiguous()
    din = x.shape[-1]
    rows = x.numel() // din if din else 0
    args, ndt, _keep = chain_launch_args(x, a, b, rows)
    dout = b.w.shape[-1]
    out = torch.empty(*x.shape[:-1], dout, dtype=x.dtype, device=x.device)
    if rows == 0 or dout == 0:
        return out
    if rows >= 2**31 or din >= 2**31 or dout >= 2**31:
        raise ValueError("member_lora_delta dimensions must fit in 32 bits")
    rows_per_lane, lanes = args[8:10]  # after the factors' 8 pointers
    _launch(x, out, args, ndt, scale, _plan(rows_per_lane, lanes, din, dout, x.dtype, x.data_ptr()))
    if not torch.cuda.is_current_stream_capturing():  # a graph's replays run what a capture records
        member_lora_delta.launches += 1
    return out


member_lora_delta.launches = 0
