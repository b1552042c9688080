"""Ring attention: exact attention with the sequence sharded over the
processes of an ``sp`` group (port of
``hyperscalees_t2i_tpu/ops/ring_attention.py``).

Each process holds one block of the sequence's queries, keys and values. It
attends its queries to its own K/V block first, then passes the K/V block
and its key mask to the next rank of the ring and receives the previous
rank's (``parallel.collectives.ppermute_ring``), n − 1 times, accumulating
in online-softmax form (running max, running denominator, rescaled f32
accumulator) over tiles of ``KV_CHUNK`` keys, so no ``[L, L]`` tensor
exists and a logit tile is ``[B, H, Lq, KV_CHUNK]``. Non-causal; masked
keys (``kv_mask`` False) get ``NEG_INF``. Forward only.

The JAX function is XLA math, not a Pallas kernel, and this is plain torch:
the rotation is a gloo exchange through host copies, so it runs eagerly,
outside any CUDA graph.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_gather_tree, axis_size, ppermute_ring

NEG_INF = -1e30
KV_CHUNK = 512  # per-step logit tile: [B, H, Lq_local, KV_CHUNK] f32 max

# the ring's exchanges: calls and host seconds (copies included)
RING_STATS: Dict[str, List[float]] = {"ppermute": [0, 0.0], "all_gather": [0, 0.0]}


def _attend_block(q, k_blk, v_blk, mask_blk, m, l, acc, scale):
    """Online-softmax update of ``(m, l, acc)`` with one K/V block, in
    ``KV_CHUNK`` tiles (the last one padded with masked keys)."""
    Lb = k_blk.shape[1]
    chunk = min(KV_CHUNK, Lb)
    nc = -(-Lb // chunk)
    pad = nc * chunk - Lb
    if pad:
        k_blk = F.pad(k_blk, (0, 0, 0, 0, 0, pad))
        v_blk = F.pad(v_blk, (0, 0, 0, 0, 0, pad))
        mask_blk = F.pad(mask_blk, (0, pad))
    qf = q.to(torch.float32)
    for c in range(nc):
        kt = k_blk[:, c * chunk:(c + 1) * chunk].to(torch.float32)
        vt = v_blk[:, c * chunk:(c + 1) * chunk]
        mt = mask_blk[:, c * chunk:(c + 1) * chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt) * scale
        s = torch.where(mt[:, None, None, :], s, torch.full((), NEG_INF, device=s.device))
        m_new = torch.maximum(m, s.amax(dim=-1))  # [B, H, Lq]
        p = torch.exp(s - m_new[..., None])
        correction = torch.exp(m - m_new)
        l = l * correction + p.sum(dim=-1)
        # p rounded to v's dtype, the products accumulated in f32
        acc = acc * correction[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vt.dtype).to(torch.float32), vt.to(torch.float32))
        m = m_new
    return m, l, acc


def _ppermute(x: torch.Tensor, group: Any) -> torch.Tensor:
    t0 = time.perf_counter()
    out = ppermute_ring(x, group=group)
    RING_STATS["ppermute"][0] += 1
    RING_STATS["ppermute"][1] += time.perf_counter() - t0
    return out


def local_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor,
                         group: Any = None) -> torch.Tensor:
    """This rank's block: ``q``/``k``/``v [B, L_local, H, dh]``, ``kv_mask
    [B, L_local]`` (bool); exact attention of the local queries over the
    whole sequence of the group (default: the launch) → ``[B, L_local, H,
    dh]`` in q's dtype. The local block is attended first, then each block
    as it arrives; the last one is not passed on."""
    B, Lq, H, dh = q.shape
    n = axis_size(group)
    scale = 1.0 / math.sqrt(dh)
    m = torch.full((B, H, Lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Lq, dh), dtype=torch.float32, device=q.device)
    for _ in range(n - 1):
        m, l, acc = _attend_block(q, k, v, kv_mask, m, l, acc, scale)
        k, v, kv_mask = _ppermute(k, group), _ppermute(v, group), _ppermute(kv_mask, group)
    m, l, acc = _attend_block(q, k, v, kv_mask, m, l, acc, scale)
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # [B, H, Lq, dh]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: Any = None, axis: str = "sp",
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact full attention of ``q``/``k``/``v [B, L, H, dh]`` (the whole
    sequence, the same on every rank, as the JAX function's global arrays)
    with the sequence sharded over ``group`` (default: the launch): rank
    ``i`` attends block ``i`` (:func:`local_ring_attention`) and the blocks
    are gathered back into ``[B, L, H, dh]``. ``kv_mask [B, L]`` bool, True
    = attend. ``L`` must divide by the group's size."""
    B, L, H, dh = q.shape
    n = axis_size(group)
    if L % n:
        raise ValueError(f"sequence length {L} not divisible by {axis}={n}")
    if kv_mask is None:
        kv_mask = torch.ones((B, L), dtype=torch.bool, device=q.device)
    if n <= 1:
        return local_ring_attention(q, k, v, kv_mask.to(torch.bool), group)
    import torch.distributed as dist

    i, bl = dist.get_rank(group), L // n
    blk = slice(i * bl, (i + 1) * bl)
    out = local_ring_attention(q[:, blk], k[:, blk], v[:, blk], kv_mask[:, blk].to(torch.bool), group)
    t0 = time.perf_counter()
    full = all_gather_tree(out, axis=1, group=group)
    RING_STATS["all_gather"][0] += 1
    RING_STATS["all_gather"][1] += time.perf_counter() - t0
    return full
