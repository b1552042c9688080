"""Decode attention against a partially filled KV cache, and its CUDA kernel (K4).

Port of ``hyperscalees_t2i_tpu/ops/attention.py``. There the Pallas kernel
``_flash_kernel`` runs online-softmax attention of a query block against the
first ``kv_len`` positions of a KV cache, with the kv axis as a sequential
grid dimension over head-major, block-padded copies. Here the kernel is
``csrc/decode_attention.cu`` (its note says what bounds it and how it is
laid out), built by ``nvcc`` at first use and called through ``ctypes`` on
PyTorch's current stream. It reads q, K and V in place through their strides
and reads nothing past ``kv_len``. bf16 runs on the tensor cores
(FlashAttention-2 on ``mma.sync``, P rounded to bf16), f32 on the CUDA cores.

- :func:`decode_attention` — the wrapper. A CPU tensor takes the plain
  version :func:`naive_masked_attention`; a CUDA tensor launches the kernel
  once by :func:`_plan` or raises. ``decode_attention.launches`` counts
  kernel launches (not a CUDA graph's capture, whose replays run the
  kernel without the wrapper).
- :func:`_plan` — the kernel's route for one call, a pure function of nq,
  kv_len, dh, the dtype and the alignments of q, k and v.

Why the result is bitwise invariant: a query's output depends only on its
q row, its (row, head) cache prefix, ``kv_len``, its mask row and the kv
tile width ``BKV`` (64, the same for every call; the C entry refuses any
other). The plan may change the query rows of a block, the ring's stages
and the copy widths, none of which changes a row's arithmetic.

Shapes are the models' cache layout: queries ``[B, nq, H, dh]``, KV cache
``[B, L, H, dh]`` with the first ``kv_len`` positions valid, an optional
bool key mask ``[B, L]`` (padded text in cross-attention). A masked logit is
the finite ``NEG_INF``, so a row whose every key is masked averages V
uniformly over the prefix, as the JAX package's plain path does.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..obs.program_cost import kernel_cost, tensor_bytes
NEG_INF = -1e30
MAX_HEAD_DIM = 128  # csrc/decode_attention.cu's limit
BKV = 64  # cache positions per kv tile; the C entry refuses any other
_ENTRY = {torch.bfloat16: "hses_decode_attention_bf16", torch.float32: "hses_decode_attention_f32"}
# q, k, v, mask, out; B, nq, H, dh, kv_len; strides of q, k, v (batch,
# position, head), the mask's batch stride, out's strides; scale; the plan
# (rows, bkv, stages, q_vec, k_vec, v_vec); stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 13
             + [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p])


class AttentionPlan(NamedTuple):
    rows: int    # queries per block, 16 a warp: 16, 32, 64 or 128 (bf16); 64 (f32)
    bkv: int     # cache positions per kv tile: BKV
    stages: int  # kv tiles of the cp.async ring: 2 or 3 (bf16); 1 (f32, staged element by element)
    q_vec: int   # elements of q per copy: 8 (16-byte cp.async), 4 (8-byte), 1 (element loads)
    k_vec: int   # the same for the K cache
    v_vec: int   # the same for the V cache


def alignment(t: torch.Tensor) -> int:
    """The largest of 16, 8, 4 and 2 bytes that divides ``t``'s address and
    its first three strides in bytes (batch, position, head)."""
    es = t.element_size()
    bits = t.data_ptr() | 16
    for s in t.stride()[:3]:
        bits |= s * es
    return bits & -bits


def _copy_width(dh: int, align: int) -> int:
    if dh % 8 == 0 and align >= 16:
        return 8
    if dh % 4 == 0 and align >= 8:
        return 4
    return 1


def _plan(nq: int, kv_len: int, dh: int, dtype: torch.dtype,
          alignments: Tuple[int, int, int] = (16, 16, 16)) -> AttentionPlan:
    """The kernel's route for ``nq`` queries against ``kv_len`` cache
    positions of head dim ``dh``; ``alignments`` are q's, k's and v's
    (:func:`alignment`).

    bf16: each warp owns 16 query rows, and a warp wholly past nq skips the
    math and only helps stage the kv tiles, so a block's rows buy copy
    threads, not work. The rule is the sweep's (``chip_smoke.k4_tile_sweep``,
    PERF.md): 64 rows (4 warps) at nq ≤ 64; above, 128 (8 warps, each kv
    tile staged once for twice the queries) where that pads no more rows
    than 64 does (nq 100, 256), else 64 (nq 169: 192 rows, not 256). The
    ring holds 3 kv tiles of ``BKV`` positions at 128 rows, where registers
    already hold the SM to two blocks, and 2 otherwise, where a third stage
    would cost a block an SM. A copy of 16 bytes needs dh % 8 and 16-byte
    alignment, of 8 bytes dh % 4 and 8-byte alignment, else element copies.
    f32 takes its one route: 64-query tiles staged element by element."""
    if dtype == torch.float32:
        return AttentionPlan(64, BKV, 1, 1, 1, 1)
    if dtype != torch.bfloat16:
        raise TypeError(f"decode_attention takes bf16 or f32, got {dtype}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention's kernel takes head dims up to {MAX_HEAD_DIM}, got {dh}")
    rows = 128 if nq > 64 and -(-nq // 128) * 128 <= -(-nq // 64) * 64 else 64
    return AttentionPlan(rows, BKV, 3 if rows == 128 else 2, *(_copy_width(dh, a) for a in alignments))


def naive_masked_attention(
    q: torch.Tensor,  # [B, nq, H, dh]
    k: torch.Tensor,  # [B, L, H, dh]
    v: torch.Tensor,  # [B, L, H, dh]
    kv_len: Optional[int],
    kv_mask: Optional[torch.Tensor],
    sm_scale: float,
) -> torch.Tensor:
    """Plain version (``_naive_masked_attention``): the valid prefix sliced,
    f32 logits times ``sm_scale``, masked keys at ``NEG_INF``, f32 softmax,
    f32 ``P @ V``, cast to q's dtype."""
    if kv_len is not None and kv_len < k.shape[1]:
        k, v = k[:, :kv_len], v[:, :kv_len]
        if kv_mask is not None:
            kv_mask = kv_mask[:, :kv_len]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * sm_scale
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32)).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int, kv_mask: Optional[torch.Tensor]) -> None:
    if q.dtype not in _ENTRY:
        raise TypeError(f"decode_attention takes bf16 or f32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q [B,nq,H,dh], k and v [B,L,H,dh] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, dh = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, dh):
        raise ValueError(f"q {tuple(q.shape)} and cache {tuple(k.shape)} disagree on B, H or dh")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention's kernel takes head dims up to {MAX_HEAD_DIM}, got {dh}")
    if not 1 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside 1..{k.shape[1]}")
    if kv_mask is not None:
        if kv_mask.dtype != torch.bool or kv_mask.ndim != 2 or kv_mask.shape[0] != B or kv_mask.shape[1] < kv_len:
            raise ValueError(f"kv_mask must be bool [B, >= kv_len], got {kv_mask.dtype} {tuple(kv_mask.shape)}")
    devices = {t.device for t in (q, k, v) + ((kv_mask,) if kv_mask is not None else ())}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and the mask lie on different devices: {sorted(map(str, devices))}")


def decode_attention_cost(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, kv_len: Optional[int] = None,
                          kv_mask: Optional[torch.Tensor] = None, sm_scale: Optional[float] = None) -> Tuple[int, int]:
    """``(FLOPs, bytes)`` of one call: ``4·B·H·nq·kv_len·dh`` (QKᵀ and PV
    over the valid prefix); q, the cache's and the mask's first ``kv_len``
    positions read once, the output written once."""
    B, nq, H, dh = q.shape
    L = k_cache.shape[1] if kv_len is None else int(kv_len)
    kv = 2 * B * L * H * dh * k_cache.element_size()
    mask = B * L * kv_mask.element_size() if kv_mask is not None else 0
    return 4 * B * H * nq * L * dh, 2 * tensor_bytes(q) + kv + mask


@kernel_cost(decode_attention_cost)
def decode_attention(
    q: torch.Tensor,  # [B, nq, H, dh]
    k_cache: torch.Tensor,  # [B, L, H, dh]
    v_cache: torch.Tensor,
    kv_len: Optional[int] = None,
    kv_mask: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked attention of a query block against the first ``kv_len``
    (default: all) positions of a KV cache → ``[B, nq, H, dh]`` in q's
    dtype. ``sm_scale`` defaults to ``1/sqrt(dh)``. On the CPU this is the
    plain version; on CUDA the kernel runs on the current stream (bf16 or
    f32, ``dh`` ≤ 128, the head dimension contiguous), and anything it does
    not take raises."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    L = k_cache.shape[1]
    kv_len = L if kv_len is None else int(kv_len)
    if q.device.type == "cpu":
        return naive_masked_attention(q, k_cache, v_cache, kv_len, kv_mask, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k_cache, v_cache, kv_len, kv_mask)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k_cache, v_cache))
    B, nq, H, dh = q.shape
    out = torch.empty(B, nq, H, dh, dtype=q.dtype, device=q.device)
    if B == 0 or nq == 0 or H == 0:
        return out
    mask = None
    if kv_mask is not None:
        mask = kv_mask if kv_mask.stride(-1) == 1 else kv_mask.contiguous()
    _launch(q, k, v, mask, out, kv_len, sm_scale,
            _plan(nq, kv_len, dh, q.dtype, (alignment(q), alignment(k), alignment(v))))
    if not torch.cuda.is_current_stream_capturing():  # a graph's replays run what a capture records
        decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor], out: torch.Tensor,
            kv_len: int, sm_scale: float, plan: AttentionPlan) -> None:
    """One launch of the kernel by ``plan`` on q's device and current
    stream, into ``out`` (q's shape and dtype); raises if it is refused."""
    from ._build import entry

    B, nq, H, dh = q.shape
    fn = entry("decode_attention", _ENTRY[q.dtype], _ARGTYPES)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               mask.stride(0) if mask is not None else 0, *out.stride()[:3]]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr() if mask is not None else None,
                 out.data_ptr(), B, nq, H, dh, kv_len, *strides, float(sm_scale), *plan,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
