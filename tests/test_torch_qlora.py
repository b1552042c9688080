"""The fused int8 + perturbed-LoRA kernel K3 (``ops/fused_qlora.py``,
``csrc/fused_qlora.cu``): its plan, and the arithmetic of its tensor-core
route, on the CPU; the kernel itself on the card (``cuda``-marked tests,
skipped without one).

The plain version's parity with the JAX package's Pallas kernel (interpret
mode, with and without lanes) is held by ``tests/test_torch_kernels.py``
(``test_k3_*``). Here:

- ``_plan`` is a pure function of the shape, the lanes, the dtype and the
  pointers: the tile follows the rows, lanes and N, the depth of a stage of
  the k sum (``bk``) does not, and copy widths respect K, N and alignment.
- The hi/lo split the kernel applies to f32 factor values (a.w is θ in
  f32) before they meet bf16 x on the tensor cores: ``bf16(w) +
  bf16(w − bf16(w))`` keeps w within 2⁻¹⁶ relative, and the chain formed
  from the split sums matches ``chain_reference`` within 1e-5 of the
  largest output.
"""

import math

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu_torch.lora import FactoredDelta
from hyperscalees_t2i_tpu_torch.ops.fused_lora import chain_reference
from hyperscalees_t2i_tpu_torch.ops.fused_qlora import _plan, fused_qlora_matmul, fused_qlora_reference
from hyperscalees_t2i_tpu_torch.ops.quant_mm import F32_ROWS8, F32_TILE, MMA_16x64, MMA_64x64, MMA_128x128

torch.set_num_threads(1)

SMS = 132
TILE_DIMS = {MMA_128x128: (128, 128), MMA_64x64: (64, 64), MMA_16x64: (16, 64)}
# the flagship's LoRA-adapted int8 DiT sites: (T, din, dout, main-path dtype)
K3_SITES = [(1, 2240, 13440, torch.float32), (32, 2304, 2240, torch.bfloat16), (32, 2240, 2240, torch.bfloat16),
            (1024, 2240, 2240, torch.bfloat16), (1024, 2240, 32, torch.bfloat16)]


def _blocks(plan, rows_per_lane, lanes, N):
    if plan.tile == F32_ROWS8:
        return lanes * -(-N // 32)
    bm, bn = TILE_DIMS[plan.tile] if plan.tile in TILE_DIMS else (64, 64)
    return lanes * -(-rows_per_lane // bm) * -(-N // bn)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N", sorted({(k, n) for _, k, n, _ in K3_SITES} | {(37, 40), (2306, 2248)}))
def test_qlora_plan_sum_order_ignores_rows_and_lanes_and_copies_respect_alignment(K, N, dtype):
    """Batch and lane invariance rest on the plan: the tile may follow the
    rows of a lane, the lanes and N; the depth of a stage of the k sum may
    not, and the C entry refuses any other. 16-byte copies of x only where
    K % 8 and x's address allow, 8-byte where K % 4 and 8-byte alignment
    allow; 16-byte copies of q8 only where N % 16 and q8's address allow."""
    depths, tiles = set(), set()
    for rows in (1, 2, 8, 9, 32, 257, 1024):
        for lanes in (1, 2, 4, 16):
            for x_ptr in (0, 8, 2, 4096 + 2 * K):
                for q_ptr in (0, 4):
                    p = _plan(rows, lanes, K, N, dtype, x_ptr, q_ptr)
                    depths.add(p.bk)
                    tiles.add(p.tile)
                    if dtype == torch.float32:
                        assert p.tile == (F32_ROWS8 if rows <= 8 else F32_TILE) and p.a_vec == p.b_vec == 0
                        continue
                    assert p.tile in TILE_DIMS
                    assert p.a_vec in (1, 4, 8) and p.b_vec in (1, 16)
                    if p.a_vec == 8:
                        assert K % 8 == 0 and x_ptr % 16 == 0
                    if p.a_vec == 4:
                        assert K % 4 == 0 and x_ptr % 8 == 0
                    if p.b_vec == 16:
                        assert N % 16 == 0 and q_ptr % 16 == 0
    assert depths == {64 if dtype == torch.bfloat16 else 32}
    assert len(tiles) >= 2  # the tile does follow the shape
    p = _plan(1024, 1, K, N, dtype, 0, 0)
    if dtype == torch.bfloat16:
        assert p.a_vec == (8 if K % 8 == 0 else 4 if K % 4 == 0 else 1)
        assert p.b_vec == (16 if N % 16 == 0 else 1)


def test_qlora_plan_follows_lanes_and_fills_the_card():
    """The flagship's K3 shapes put at least half a wave of 132 SMs on the
    card; proj_out (N = 32: one column tile) gets as many blocks as any
    tile can give it. Lanes count as blocks: four lanes of 32 rows take a
    wider tile than one."""
    for T, K, N, dt in K3_SITES:
        p = _plan(T, 1, K, N, dt)
        most = max(_blocks(p._replace(tile=t), T, 1, N) for t in TILE_DIMS) if dt == torch.bfloat16 else 0
        if N >= 64:
            assert _blocks(p, T, 1, N) >= SMS / 2, (T, K, N)
        else:
            assert _blocks(p, T, 1, N) == most
    bf = torch.bfloat16
    assert _plan(32, 1, 2240, 2240, bf).tile == MMA_16x64       # 2 × 35 = 70 blocks
    assert _plan(32, 4, 2240, 2240, bf).tile != MMA_16x64       # 4 lanes: 140 blocks of 64×64
    with pytest.raises(TypeError):
        _plan(4, 1, 8, 8, torch.float16)


def _split(w):
    hi = w.to(torch.bfloat16)
    return hi, (w - hi.float()).to(torch.bfloat16)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.0])
def test_hi_lo_split_keeps_f32_theta_to_2_pow_minus_16(scale):
    """``bf16(w) + bf16(w − bf16(w))`` reproduces f32 w within 2⁻¹⁶ of |w|
    (measured: ≤ 2⁻¹⁷ here); a value already exact in bf16 (the bf16 noise
    store) splits into itself and an exact 0."""
    g = torch.Generator().manual_seed(7)
    w = torch.randn(2240, 8, generator=g) * scale
    hi, lo = _split(w)
    err = (hi.float() + lo.float() - w).abs()
    assert bool((err <= 2.0 ** -16 * w.abs()).all())
    u = torch.randn(2240, 4, generator=g).to(torch.bfloat16).float()
    hu, lu = _split(u)
    assert torch.equal(hu.float(), u) and not bool(lu.float().any())


@pytest.mark.parametrize("noise", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lanes", [0, 3])
def test_chain_from_split_operands_matches_chain_reference(noise, lanes):
    """The kernel's chain: bf16 x against the hi and the lo columns of a.w
    (and of a.u) summed apart in f32 and added, then xa, xb and the output
    in f32. It matches ``chain_reference`` (the plain version's f32 chain)
    within 1e-5 of the largest output."""
    g = torch.Generator().manual_seed(11)
    din, dout, rl, re, T = 2240, 96, 8, 4, 40
    n = max(lanes, 1)
    sh = (lanes,) if lanes else ()

    def factor(m, k):
        return FactoredDelta(torch.randn(m, k, generator=g) / math.sqrt(m),
                             torch.randn(*sh, m, re, generator=g).to(noise),
                             torch.randn(*sh, k, re, generator=g).to(noise),
                             torch.rand(sh, generator=g) * 0.2 - 0.1)

    a, b = factor(din, rl), factor(rl, dout)
    x3 = torch.randn(n, T, din, generator=g).to(torch.bfloat16).float()
    ref = chain_reference(x3, a, b)

    aw_hi, aw_lo = _split(a.w)
    au = a.u.float() if lanes else a.u.float()[None]
    au_hi, au_lo = _split(au)
    xw = x3 @ aw_hi.float() + x3 @ aw_lo.float()
    xu = x3 @ au_hi.float() + x3 @ au_lo.float()
    av = a.v.float() if lanes else a.v.float()[None]
    ca = a.c.float().reshape(-1, 1, 1)
    xa = xw + ca * (xu @ av.transpose(-1, -2))
    bu = b.u.float() if lanes else b.u.float()[None]
    bv = b.v.float() if lanes else b.v.float()[None]
    cb = b.c.float().reshape(-1, 1, 1)
    got = xa @ b.w + cb * ((xa @ bu) @ bv.transpose(-1, -2))
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err


# ---------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")


def _card_factor(g, m, k, re, dt, lanes):
    sh = (lanes,) if lanes else ()
    return FactoredDelta(torch.randn(m, k, generator=g, device="cuda") / math.sqrt(m),
                         torch.randn(*sh, m, re, generator=g, device="cuda").to(dt),
                         torch.randn(*sh, k, re, generator=g, device="cuda").to(dt),
                         torch.rand(sh, generator=g, device="cuda") * 0.02 + 0.01)


def _lane(f, i):
    return FactoredDelta(f.w, f.u[i], f.v[i], f.c[i])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("T", [1024, 32])
def test_k3_kernel_is_batch_and_lane_invariant_bitwise_on_card(dtype, T):
    """Each lane of a 4-lane call equals that lane called alone, and rows of
    a lane equal the same rows alone, bit for bit: the tile follows rows
    and lanes, the order of the k sums does not."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(3)
    dt = getattr(torch, dtype)
    din = dout = 2240
    lanes = 4
    q8 = torch.randint(-127, 128, (din, dout), generator=g, device="cuda", dtype=torch.int8)
    scale = torch.rand(1, dout, generator=g, device="cuda") * 0.001
    a, b = _card_factor(g, din, 8, 4, dt, lanes), _card_factor(g, 8, dout, 4, dt, lanes)
    x = torch.randn(lanes * T, din, generator=g, device="cuda").to(dt)
    full = fused_qlora_matmul(x, q8, scale, a, b, 2.0)
    for i in range(lanes):
        xi = x[i * T:(i + 1) * T]
        solo = fused_qlora_matmul(xi, q8, scale, _lane(a, i), _lane(b, i), 2.0)
        assert torch.equal(solo, full[i * T:(i + 1) * T])
    for lo, hi in ((0, 1), (0, 2), (0, 9), (T - 1, T)):
        part = fused_qlora_matmul(x[lo:hi], q8, scale, _lane(a, 0), _lane(b, 0), 2.0)
        assert torch.equal(part, full[lo:hi])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,T,din,dout,rl,re,lanes", [
    ("bfloat16", 1024, 2240, 32, 8, 4, 0),     # proj_out: one ragged column tile
    ("bfloat16", 32, 2304, 2240, 8, 4, 0),     # caption_proj/linear_1: K = 2304
    ("float32", 1, 2240, 13440, 8, 4, 0),      # time_embed/linear: f32 at T = 1
    ("bfloat16", 37, 37, 40, 16, 16, 3),       # the widest ranks, lanes
    ("bfloat16", 37, 37, 40, 16, 15, 3),       # a.u lanes 1110 bytes apart: not 16-byte aligned
    ("float32", 37, 37, 40, 16, 15, 3),
])
def test_k3_kernel_matches_reference_on_card(dtype, T, din, dout, rl, re, lanes):
    """The kernel against its plain version: bf16 within 2⁻⁷ of the largest
    output, f32 within 1e-5; and with q8 = 0 (the chain alone) at the same
    tolerance of the chain's own largest output."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(5)
    dt = getattr(torch, dtype)
    n = max(lanes, 1)
    a, b = _card_factor(g, din, rl, re, dt, lanes), _card_factor(g, rl, dout, re, dt, lanes)
    x = torch.randn(n * T, din, generator=g, device="cuda").to(dt)
    q8 = torch.randint(-127, 128, (din, dout), generator=g, device="cuda", dtype=torch.int8)
    scale = torch.rand(1, dout, generator=g, device="cuda") * 0.01
    tol = 2 ** -7 if dt == torch.bfloat16 else 1e-5
    for q in (q8, torch.zeros_like(q8)):
        before = fused_qlora_matmul.launches
        out = fused_qlora_matmul(x, q, scale, a, b, 2.0)
        torch.cuda.synchronize()
        assert fused_qlora_matmul.launches == before + 1
        ref = fused_qlora_reference(x, q, scale, a, b, 2.0).float()
        assert float((out.float() - ref).abs().max()) <= tol * float(ref.abs().max())
        assert np.isfinite(out.float().cpu().numpy()).all()
