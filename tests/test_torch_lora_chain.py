"""The perturbed-LoRA chain kernel K2 (``ops/fused_lora.py``,
``csrc/lora_chain.cu``): its plan and the arithmetic of its two routes on the
CPU, and the kernel itself on the card (``cuda``-marked tests, skipped
without one).

- ``_plan`` is a pure function of the rows, lanes, din, dout, dtype and x's
  address: its column group follows the call, the sum order (``bk``, the
  warps ``W`` and their ascending order) does not, and its grid fills the
  card.
- A torch emulation of the kernel's arithmetic: for bf16 x, the hi/lo split
  of a.w and a.u, k16 mma steps summed over each warp's 64-deep stages
  ``w, w + W, …``, the warps' partial sums added in ascending order; for f32
  x, 32-deep chunks added in ascending order; then ``xa``, ``xb`` and each
  output in ``chain_row8``'s order. At din 2240 it matches
  ``chain_reference`` within 1e-5 of the largest output (measured ≤ 2.6e-6
  of it; the hi/lo split keeps θ to 2⁻¹⁶) and the JAX package's
  ``_chain_kernel`` in interpret mode within rtol/atol 1e-5 (measured
  ≤ 4.2e-6 absolute on outputs of order 1), with no lanes and with 3.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.lora import FactoredDelta as JFD
from hyperscalees_t2i_tpu.ops.fused_lora import member_lora_delta as jchain
from hyperscalees_t2i_tpu_torch.lora import FactoredDelta
from hyperscalees_t2i_tpu_torch.ops.fused_lora import (
    F32_ROWS8, MAX_COLS, MMA_ROWS32, WARPS, _plan, chain_reference, member_lora_delta, member_lora_delta_reference,
)

torch.set_num_threads(1)

SMS = 132
# the flagship's LoRA-adapted DiT sites: (T, din, dout, main-path dtype, calls per ES image)
K2_SITES = [(1, 2240, 13440, torch.float32, 1), (32, 2304, 2240, torch.bfloat16, 1),
            (32, 2240, 2240, torch.bfloat16, 41), (1024, 2240, 2240, torch.bfloat16, 120),
            (1024, 2240, 32, torch.bfloat16, 1)]
LANE_AXES = JFD(None, 0, 0, 0)  # w shared, one (u, v, c) per lane


def _blocks(p, rows_per_lane, lanes, N):
    return lanes * -(-rows_per_lane // p.rows) * -(-N // p.cols)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K", [2240, 2304, 37, 2250])
def test_chain_plan_sum_order_ignores_rows_lanes_din_and_pointers(K, dtype):
    """Batch and lane invariance rest on the plan: the column group may
    follow the rows, lanes and dout; the depth of a stage of the k sum and
    the warps that split it may not, and the C entry refuses any other.
    16-byte copies of bf16 x only where K % 8 and x's address allow, 8-byte
    where K % 4 and 8-byte alignment allow."""
    depths, warps, cols = set(), set(), set()
    for rows in (1, 2, 8, 9, 31, 32, 33, 257, 1024):
        for lanes in (1, 2, 4, 16):
            for N in (13440, 2240, 40, 32):
                for x_ptr in (0, 8, 2, 4096 + 2 * K):
                    p = _plan(rows, lanes, K, N, dtype, x_ptr)
                    depths.add(p.bk)
                    warps.add(p.warps)
                    cols.add(p.cols)
                    assert p.cols % 8 == 0 and 8 <= p.cols <= MAX_COLS
                    if dtype == torch.float32:
                        assert (p.route, p.rows, p.a_vec) == (F32_ROWS8, 8, 0)
                        continue
                    assert (p.route, p.rows) == (MMA_ROWS32, 32)
                    assert p.a_vec in (1, 4, 8)
                    if p.a_vec == 8:
                        assert K % 8 == 0 and x_ptr % 16 == 0
                    if p.a_vec == 4:
                        assert K % 4 == 0 and x_ptr % 8 == 0
    assert depths == {64 if dtype == torch.bfloat16 else 32}
    assert warps == {WARPS} == {8}
    assert len(cols) >= 3  # the column group does follow the call
    if dtype == torch.bfloat16:
        assert _plan(1024, 1, K, 2240, dtype, 0).a_vec == (8 if K % 8 == 0 else 4 if K % 4 == 0 else 1)
    with pytest.raises(TypeError):
        _plan(4, 1, K, 8, torch.float16)


def test_chain_plan_fills_the_card():
    """At least 128 blocks (and no second wave) at 1024×2240×2240, at least
    32 at T = 32, between 50 and 132 column groups at T = 1 against 13440
    columns; lanes count as blocks."""
    bf = torch.bfloat16
    assert 128 <= _blocks(_plan(1024, 1, 2240, 2240, bf), 1024, 1, 2240) <= SMS
    for K in (2240, 2304):
        assert _blocks(_plan(32, 1, K, 2240, bf), 32, 1, 2240) >= 32
    assert 50 <= _blocks(_plan(1, 1, 2240, 13440, torch.float32), 1, 1, 13440) <= SMS
    assert _blocks(_plan(32, 4, 2240, 2240, bf), 32, 4, 2240) >= 128
    for T, K, N, dt, _ in K2_SITES:
        assert _blocks(_plan(T, 1, K, N, dt), T, 1, N) >= 32, (T, K, N)


# ------------------------------------------------------- the kernel's arithmetic


def _split(w):
    hi = w.to(torch.bfloat16).float()
    return hi, (w - hi).to(torch.bfloat16).float()


def _laned(f, lanes):
    """(u, v, c) of a factor as [n, ...] f32 (n = 1 without lanes)."""
    u, v, c = f.u.float(), f.v.float(), f.c.float().reshape(-1)
    return (u, v, c) if lanes else (u[None], v[None], c)


def _thin_sums(x3, thin, dtype):
    """x @ thin [n, din, C] summed in the kernel's order: bf16, k16 steps
    through each warp's 64-deep stages, hi and lo apart, the warps' partial
    sums (hi + lo) added in ascending order; f32, 32-deep chunks added in
    ascending order."""
    din = x3.shape[-1]
    if dtype == torch.float32:
        total = torch.zeros(*x3.shape[:-1], thin.shape[-1])
        for k0 in range(0, din, 32):
            total = total + x3[..., k0:k0 + 32] @ thin[:, k0:k0 + 32]
        return total
    hi, lo = _split(thin)
    stages = -(-din // 64)
    total = None
    for w in range(WARPS):
        acc_hi = torch.zeros(*x3.shape[:-1], thin.shape[-1])
        acc_lo = torch.zeros_like(acc_hi)
        for s in range(w, stages, WARPS):
            for k0 in range(64 * s, min(64 * s + 64, din), 16):
                acc_hi = acc_hi + x3[..., k0:k0 + 16] @ hi[:, k0:k0 + 16]
                acc_lo = acc_lo + x3[..., k0:k0 + 16] @ lo[:, k0:k0 + 16]
        part = acc_hi + acc_lo
        total = part if total is None else total + part
    return total


def emulate_kernel(x3, a, b, dtype, lanes):
    """The kernel's f32 chain, before ``scale``, for x3 [n, T, din]."""
    au, av, ca = _laned(a, lanes)
    bu, bv, cb = _laned(b, lanes)
    rl, re = a.w.shape[1], au.shape[-1]
    thin = torch.cat([a.w.float()[None].expand(au.shape[0], -1, -1), au], dim=-1)
    sums = _thin_sums(x3, thin, dtype)
    xw, xu = sums[..., :rl], sums[..., rl:]
    # xa, xb and each output: FMA chains in ascending order (chain_xa_xb, chain_row8)
    s = torch.zeros_like(xw)
    for j in range(re):
        s = s + xu[..., j:j + 1] * av[:, None, :, j]
    xa = ca[:, None, None] * s + xw
    xb = torch.zeros_like(xu)
    for l_ in range(rl):
        xb = xb + xa[..., l_:l_ + 1] * bu[:, None, l_, :]
    s = torch.zeros(*xa.shape[:-1], b.w.shape[1])
    for l_ in range(rl):
        s = s + xa[..., l_:l_ + 1] * b.w.float()[l_]
    t = torch.zeros_like(s)
    for j in range(re):
        t = t + xb[..., j:j + 1] * bv[:, None, :, j]
    return cb[:, None, None] * t + s


def _inputs(seed, lanes, noise, din=2240, dout=96, T=40, rl=8, re=4):
    """numpy inputs at the ES path's scales: x [n, T, din] (bf16-exact
    values, unit variance), a.w [din, r_l] ~ N(0, 1/din), a small trained
    b.w ~ N(0, 0.01/r_l), noise u, v ~ N(0, 1) and c = σ/√r_e · (1 + U[0, 1))
    with σ = 0.01, so that the delta is of order 1; factors as JAX
    FactoredDelta."""
    r = np.random.default_rng(seed)
    n = max(lanes, 1)
    sh = (lanes,) if lanes else ()
    rnd = lambda a: np.asarray(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float())  # noqa: E731
    nz = rnd if noise == torch.bfloat16 else (lambda a: a.astype(np.float32))

    def factor(m, k, w_std):
        return JFD(jnp.asarray(r.normal(size=(m, k)) * w_std, jnp.float32),
                   jnp.asarray(nz(r.normal(size=(*sh, m, re)))), jnp.asarray(nz(r.normal(size=(*sh, k, re)))),
                   jnp.asarray(0.01 / np.sqrt(re) * (1 + r.uniform(size=sh)), jnp.float32))

    x = rnd(r.normal(size=(n, T, din)))
    return x, factor(din, rl, 1 / np.sqrt(din)), factor(rl, dout, 0.1 / np.sqrt(rl))


def _port(f, noise):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return FactoredDelta(t(f.w), t(f.u).to(noise), t(f.v).to(noise), t(f.c))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("noise", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lanes", [0, 3])
def test_kernel_arithmetic_matches_chain_reference_and_jax(lanes, noise, dtype):
    """The emulated kernel against ``chain_reference`` (within 1e-5 of the
    largest output) and against the JAX ``_chain_kernel`` in interpret mode
    (rtol/atol 1e-5; ``vmap`` over lanes)."""
    x, ja, jb = _inputs(17 + lanes, lanes, noise)
    a, b = _port(ja, noise), _port(jb, noise)
    x3 = torch.from_numpy(x)
    got = emulate_kernel(x3, a, b, dtype, lanes) * 2.0
    ref = chain_reference(x3, a, b) * 2.0
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err
    if lanes:
        j = jax.vmap(lambda xx, aa, bb: jchain(xx, aa, bb, 2.0, interpret=True),
                     in_axes=(0, LANE_AXES, LANE_AXES))(jnp.asarray(x), ja, jb)
    else:
        j = jchain(jnp.asarray(x[0]), ja, jb, 2.0, interpret=True)[None]
    np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_warp_split_covers_every_stage_once():
    """The stages dealt to the W warps (warp w: w, w + W, …) cover the k walk
    once, for any din: 37 (one stage, warps 1-7 idle), 2240 (35 stages: 5 for
    warps 0-2, 4 for the rest) and 2304 (36)."""
    for din in (37, 64, 2240, 2304, 4096 + 1):
        stages = -(-din // 64)
        dealt = sorted(s for w in range(WARPS) for s in range(w, stages, WARPS))
        assert dealt == list(range(stages))
        mine = [(stages - w + WARPS - 1) // WARPS if w < stages else 0 for w in range(WARPS)]
        assert sum(mine) == stages and max(mine) - min(mine) <= 1


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
@pytest.mark.parametrize("site", range(len(K2_SITES)))
def test_k2_kernel_matches_reference_at_every_chain_shape_on_card(site, dtype):
    """Every adapted-site shape, both dtypes (noise bf16 at the main-path
    dtype, f32 otherwise): bf16 within 2⁻⁷ of the largest output, f32 within
    1e-5; one launch a call."""
    _card()
    T, din, dout, main_dt, _ = K2_SITES[site]
    dt = getattr(torch, dtype)
    ndt = torch.bfloat16 if dt == main_dt else torch.float32
    g = torch.Generator(device="cuda").manual_seed(site)
    a, b = _card_factor(g, din, 8, 4, ndt, 0), _card_factor(g, 8, dout, 4, ndt, 0)
    x = torch.randn(T, din, generator=g, device="cuda").to(dt)
    before = member_lora_delta.launches
    out = member_lora_delta(x, a, b, 2.0)
    torch.cuda.synchronize()
    assert member_lora_delta.launches == before + 1
    ref = member_lora_delta_reference(x, a, b, 2.0).float()
    tol = 2 ** -7 if dt == torch.bfloat16 else 1e-5
    assert float((out.float() - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("T", [1024, 32])
def test_k2_kernel_is_batch_and_lane_invariant_bitwise_on_card(dtype, T):
    """Each lane of a 4-lane call equals that lane called alone, and rows of
    a lane equal the same rows alone, bit for bit: the column group follows
    rows and lanes, the order of the k sums does not."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(4)
    dt = getattr(torch, dtype)
    din = dout = 2240
    lanes = 4
    a, b = _card_factor(g, din, 8, 4, dt, lanes), _card_factor(g, 8, dout, 4, dt, lanes)
    x = torch.randn(lanes * T, din, generator=g, device="cuda").to(dt)
    full = member_lora_delta(x, a, b, 2.0)
    for i in range(lanes):
        solo = member_lora_delta(x[i * T:(i + 1) * T], _lane(a, i), _lane(b, i), 2.0)
        assert torch.equal(solo, full[i * T:(i + 1) * T])
    for lo, hi in ((0, 1), (0, 2), (0, 9), (T - 1, T)):
        part = member_lora_delta(x[lo:hi], _lane(a, 0), _lane(b, 0), 2.0)
        assert torch.equal(part, full[lo:hi])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,T,din,dout,rl,re,lanes", [
    ("bfloat16", 37, 37, 40, 16, 16, 3),       # the widest ranks (wide route), lanes, ragged everything
    ("bfloat16", 37, 37, 40, 16, 15, 3),       # a.u lanes 1110 bytes apart: not 16-byte aligned
    ("bfloat16", 1, 2240, 13440, 8, 4, 0),     # bf16 at T = 1
    ("float32", 37, 37, 40, 16, 15, 3),
    ("float32", 1024, 2240, 2240, 8, 4, 2),    # f32 above 8 rows, lanes
])
def test_k2_kernel_matches_reference_off_the_main_path_on_card(dtype, T, din, dout, rl, re, lanes):
    _card()
    g = torch.Generator(device="cuda").manual_seed(6)
    dt = getattr(torch, dtype)
    n = max(lanes, 1)
    a, b = _card_factor(g, din, rl, re, dt, lanes), _card_factor(g, rl, dout, re, dt, lanes)
    x = torch.randn(n * T, din, generator=g, device="cuda").to(dt)
    out = member_lora_delta(x, a, b, 2.0)
    torch.cuda.synchronize()
    ref = member_lora_delta_reference(x, a, b, 2.0).float()
    tol = 2 ** -7 if dt == torch.bfloat16 else 1e-5
    assert float((out.float() - ref).abs().max()) <= tol * float(ref.abs().max())
    assert np.isfinite(out.float().cpu().numpy()).all()
