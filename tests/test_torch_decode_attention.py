"""The decode-attention kernel K4 (``ops/attention.py``,
``csrc/decode_attention.cu``): its plan and the arithmetic of its bf16 route
on the CPU, and the kernel itself on the card (``cuda``-marked tests,
skipped without one).

- ``_plan`` is a pure function of nq, kv_len, dh, the dtype and the
  alignments of q, k and v: rows per block follow nq (16 rows a warp; 64
  or 128 rows by the rule ``chip_smoke.k4_tile_sweep`` measured), the kv
  tile is 64 positions at every call, dh pads to a multiple of 16, and the
  copy widths fall back as dh, the strides and the pointers forbid.
- A torch emulation of the bf16 route's arithmetic: bf16 operands with f32
  sums, kv tiles of 64 positions walked in order, positions past ``kv_len``
  zero-filled and absent (p = 0), masked keys at ``NEG_INF``, the scale
  folded with log2(e) into ``exp2``, the f32 running max and sum, P rounded
  to bf16 before ``P @ V``, one division by ``max(l, 1e-30)`` and a bf16
  output (the kernel's full unmasked tiles fold the scale and the max into
  one FFMA where this takes two roundings, far below the bound). On the inputs rounded to bf16 it matches the JAX package's
  ``_pallas_attention(..., interpret=True)`` and ``_naive_masked_attention``
  within 2⁻⁷ of the largest output, the bound ``chip_smoke.py`` holds the
  card to (measured ≤ 3.1e-3 of it on every case of
  tests/test_attention.py, ≤ 3.4e-3 at VAR-d16's inputs), ignores NaN past
  ``kv_len`` bitwise, and averages V uniformly over the prefix in an
  all-masked row.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_attention import CASES, _inputs

from hyperscalees_t2i_tpu.ops.attention import _naive_masked_attention, _pallas_attention
from hyperscalees_t2i_tpu_torch.ops.attention import (
    BKV, MAX_HEAD_DIM, NEG_INF, AttentionPlan, _launch, _plan, alignment, decode_attention, naive_masked_attention,
)

torch.set_num_threads(1)
BOUND = 2 ** -7  # of the largest output: bf16 on the card (chip_smoke.check_close)
LOG2E = 1.4426950408889634
# VAR-d16's scales: (queries pn², kv_len) against a 680-position cache
VAR_SCALES = [(1, 1), (4, 5), (9, 14), (16, 30), (25, 55), (36, 91), (64, 155), (100, 255), (169, 424), (256, 680)]


# ------------------------------------------------------------------- the plan


def test_plan_rows_per_block_follow_nq_at_each_var_d16_scale():
    """64 rows (4 warps) at nq ≤ 64, where warps past nq only help stage the
    kv tiles; above, 128 rows where that pads no more rows than 64, else 64.
    Kv tiles of 64 at every scale; 3 ring stages at 128 rows, else 2."""
    want_rows = [64, 64, 64, 64, 64, 64, 64, 128, 64, 128]
    for (nq, kv), rows in zip(VAR_SCALES, want_rows):
        p = _plan(nq, kv, 64, torch.bfloat16)
        assert p == AttentionPlan(rows, BKV, 3 if rows == 128 else 2, 8, 8, 8), (nq, kv, p)
        padded = -(-nq // rows) * rows
        assert padded <= max(-(-nq // 64) * 64, 64)
    for nq in range(1, 600):
        rows = _plan(nq, 680, 64, torch.bfloat16).rows
        assert rows in (64, 128) and -(-nq // rows) * rows - nq < 64
    assert _plan(256, 680, 64, torch.float32) == AttentionPlan(64, BKV, 1, 1, 1, 1)


@pytest.mark.parametrize("dh,aligns,want", [
    (64, (16, 16, 16), (8, 8, 8)),
    (64, (16, 8, 2), (8, 4, 1)),
    (128, (8, 16, 4), (4, 8, 1)),
    (8, (16, 16, 16), (8, 8, 8)),    # the tiny VAR: one 16-byte copy a row, the padding copy reads nothing
    (4, (16, 16, 16), (4, 4, 4)),    # odd_shapes: 8-byte copies
    (12, (16, 16, 16), (4, 4, 4)),
    (6, (16, 16, 16), (1, 1, 1)),
    (100, (16, 16, 2), (4, 4, 1)),
])
def test_plan_copy_widths_fall_back_as_dh_and_alignment_forbid(dh, aligns, want):
    p = _plan(37, 300, dh, torch.bfloat16, aligns)
    assert (p.q_vec, p.k_vec, p.v_vec) == want
    for vec in want:  # a copy never straddles dh: the padding to a multiple of 16 is whole copies
        assert dh % vec == 0 and (-(-dh // 16) * 16) % vec == 0


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="head dims up to 128"):
        _plan(4, 10, MAX_HEAD_DIM + 1, torch.bfloat16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        _plan(4, 10, 64, torch.float16)
    assert _plan(4, 10, MAX_HEAD_DIM, torch.bfloat16).rows == 64


def test_alignment_reads_the_address_and_the_strides():
    x = torch.zeros(2, 10, 4, 64, dtype=torch.bfloat16)
    assert alignment(x) == 16
    assert alignment(x[:, 1:]) == 16                  # a position is 512 bytes
    assert alignment(x[..., 4:]) == 8                 # 8 bytes into each row
    assert alignment(x[..., 1:]) == 2
    odd = torch.zeros(2, 10, 3, 6, dtype=torch.bfloat16)
    assert alignment(odd) == 4                        # head stride 12 bytes
    assert _plan(10, 10, 6, torch.bfloat16, (alignment(odd),) * 3).q_vec == 1


# ------------------------------------------------- the bf16 route, emulated


def emulate_bf16_route(q, k, v, kv_len, mask, scale):
    """The bf16 route's arithmetic in torch on the CPU: ``q [B, nq, H,
    dh]``, ``k``, ``v [B, L, H, dh]`` bf16, an optional bool mask ``[B,
    L]`` → ``[B, nq, H, dh]`` bf16."""
    f32 = torch.float32
    B, nq, H, dh = q.shape
    ntiles = -(-kv_len // BKV)
    qh = q.permute(0, 2, 1, 3).to(f32)
    kt = torch.zeros(B, H, ntiles * BKV, dh)
    vt = torch.zeros(B, H, ntiles * BKV, dh)
    kt[:, :, :kv_len] = k[:, :kv_len].permute(0, 2, 1, 3).to(f32)  # past kv_len: zero, never read
    vt[:, :, :kv_len] = v[:, :kv_len].permute(0, 2, 1, 3).to(f32)
    present = torch.arange(ntiles * BKV) < kv_len
    allowed = present[None].repeat(B, 1)
    if mask is not None:
        allowed[:, :kv_len] &= mask[:, :kv_len]
    sl2 = torch.tensor(scale, dtype=f32) * torch.tensor(LOG2E, dtype=f32)
    m = torch.full((B, H, nq), NEG_INF)
    l = torch.zeros(B, H, nq)
    o = torch.zeros(B, H, nq, dh)
    for t in range(ntiles):
        sl = slice(t * BKV, (t + 1) * BKV)
        s = qh @ kt[:, :, sl].transpose(-1, -2)  # products of bf16 values are exact in f32
        x = torch.where(allowed[:, None, None, sl], s * sl2, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(present[sl], torch.exp2(x - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.to(torch.bfloat16).to(f32) @ vt[:, :, sl]
        m = m_new
    return (o / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16).permute(0, 2, 1, 3)


def _bf16(*arrays):
    """The arrays rounded to bf16: as torch bf16 tensors and as f32 numpy."""
    ts = [None if a is None else torch.from_numpy(a) for a in arrays]
    ts = [t if t is None or t.dtype == torch.bool else t.to(torch.bfloat16) for t in ts]
    return ts, [None if t is None else (t.numpy() if t.dtype == torch.bool else t.float().numpy()) for t in ts]


def _rel_err(got, ref):
    ref = np.asarray(ref, dtype=np.float32)
    return float(np.abs(got.float().numpy() - ref).max()) / float(np.abs(ref).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_bf16_route_matches_jax_kernel_and_plain_path(case):
    """Every case of tests/test_attention.py: a prefix, the full cache, odd
    shapes (dh 4), a key mask, several kv blocks, an all-masked row."""
    q, k, v, kv_len, mask = _inputs(case)
    bq, bkv = CASES[case][-2:]
    scale = 1.0 / math.sqrt(q.shape[-1])
    (tq, tk, tv, tm), (nq_, nk, nv, nm) = _bf16(q, k, v, mask)
    got = emulate_bf16_route(tq, tk, tv, kv_len, tm, scale)
    jm = None if nm is None else jnp.asarray(nm)
    naive = _naive_masked_attention(jnp.asarray(nq_), jnp.asarray(nk), jnp.asarray(nv), kv_len, jm, scale)
    assert _rel_err(got, naive) <= BOUND
    if case != "all_masked_row":  # the Pallas grid averages an all-masked row over its padding too
        pal = _pallas_attention(jnp.asarray(nq_), jnp.asarray(nk[:, :kv_len]), jnp.asarray(nv[:, :kv_len]), kv_len,
                                None if jm is None else jm[:, :kv_len], scale, block_q=bq, block_kv=bkv,
                                interpret=True)
        assert _rel_err(got, pal) <= BOUND


@pytest.mark.parametrize("nq,kv_len", VAR_SCALES[5::2])
def test_emulated_bf16_route_at_var_d16_inputs(nq, kv_len):
    """VAR-d16's attention inputs (QK-l2: queries of norm 4, unit keys;
    normal values; dh 64, scale 1) over several kv tiles, against the JAX
    plain path."""
    r = np.random.default_rng(nq)
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)  # noqa: E731
    q = (unit(r.normal(size=(2, nq, 4, 64))) * 4).astype(np.float32)
    k = unit(r.normal(size=(2, 680, 4, 64))).astype(np.float32)
    v = r.normal(size=(2, 680, 4, 64)).astype(np.float32)
    (tq, tk, tv), (nq_, nk, nv) = _bf16(q, k, v)
    got = emulate_bf16_route(tq, tk, tv, kv_len, None, 1.0)
    ref = _naive_masked_attention(jnp.asarray(nq_), jnp.asarray(nk), jnp.asarray(nv), kv_len, None, 1.0)
    assert _rel_err(got, ref) <= BOUND


def test_emulated_bf16_route_ignores_nan_past_kv_len_and_masks_across_tiles():
    """NaN past kv_len changes nothing, bitwise; a mask that hides the first
    tiles of one row and every key of another holds across the kv walk."""
    r = np.random.default_rng(5)
    B, nq, L, H, dh, kv_len = 3, 5, 260, 2, 16, 200
    q, k, v = (r.normal(size=s).astype(np.float32) for s in ((B, nq, H, dh), (B, L, H, dh), (B, L, H, dh)))
    pos = np.arange(L)[None, :]
    mask = np.stack([pos[0] < L, pos[0] >= 130, pos[0] < 0])  # all, the last tiles only, none
    (tq, tk, tv, tm), (nq_, nk, nv, nm) = _bf16(q, k, v, mask)
    got = emulate_bf16_route(tq, tk, tv, kv_len, tm, 0.3)
    k2, v2 = tk.clone(), tv.clone()
    k2[:, kv_len:], v2[:, kv_len:] = float("nan"), float("nan")
    assert torch.equal(emulate_bf16_route(tq, k2, v2, kv_len, tm, 0.3), got)
    ref = _naive_masked_attention(jnp.asarray(nq_), jnp.asarray(nk), jnp.asarray(nv), kv_len, jnp.asarray(nm), 0.3)
    assert _rel_err(got, ref) <= BOUND
    uniform = torch.from_numpy(nv[2, :kv_len].mean(0)).expand(nq, H, dh)
    assert float((got[2].float() - uniform).abs().max()) <= BOUND * float(uniform.abs().max())


# ---------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")


def _var_inputs(g, B, nq, L, H, dh, kv_len):
    q = torch.nn.functional.normalize(torch.randn(B, nq, H, dh, generator=g, device="cuda"), dim=-1) * 4
    k = torch.nn.functional.normalize(torch.randn(B, L, H, dh, generator=g, device="cuda"), dim=-1)
    v = torch.randn(B, L, H, dh, generator=g, device="cuda")
    k[:, kv_len:], v[:, kv_len:] = float("nan"), float("nan")
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


@pytest.mark.cuda
def test_k4_bf16_rows_and_queries_are_invariant_bitwise_on_the_card():
    """VAR-d16's last scale (32 rows, 256 queries, 680 keys): a row range, a
    query range, a query range the plan tiles otherwise and a single query,
    each alone, bitwise equal to the same outputs of the full call; and every
    rows-per-block the kernel owns gives the same bits."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = _var_inputs(g, 32, 256, 680, 16, 64, 680)
    full = decode_attention(q, k, v, kv_len=680, sm_scale=1.0)
    for part, want in ((decode_attention(q[5:9], k[5:9], v[5:9], kv_len=680, sm_scale=1.0), full[5:9]),
                       (decode_attention(q[:, 37:137], k, v, kv_len=680, sm_scale=1.0), full[:, 37:137]),
                       (decode_attention(q[:, :36], k, v, kv_len=680, sm_scale=1.0), full[:, :36]),
                       (decode_attention(q[:, 200:201], k, v, kv_len=680, sm_scale=1.0), full[:, 200:201])):
        assert torch.equal(part, want)
    for rows in (16, 32, 64, 128):
        out = torch.empty_like(q)
        _launch(q, k, v, None, out, 680, 1.0, _plan(256, 680, 64, torch.bfloat16)._replace(rows=rows))
        assert torch.equal(out, full), rows
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("nq,kv_len", VAR_SCALES)
def test_k4_bf16_matches_plain_version_at_every_var_d16_scale_on_the_card(nq, kv_len):
    _card()
    g = torch.Generator(device="cuda").manual_seed(nq)
    q, k, v = _var_inputs(g, 32, nq, 680, 16, 64, kv_len)
    before = decode_attention.launches
    out = decode_attention(q, k, v, kv_len=kv_len, sm_scale=1.0)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = naive_masked_attention(q, k, v, kv_len, None, 1.0).float()
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref).abs().max()) <= BOUND * float(ref.abs().max())


@pytest.mark.cuda
def test_k4_refuses_a_plan_it_does_not_own_on_the_card():
    _card()
    q = torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16, device="cuda")
    out = torch.empty_like(q)
    good = _plan(8, 8, 64, torch.bfloat16)
    for bad in (good._replace(bkv=32), good._replace(rows=48), good._replace(stages=4),
                good._replace(k_vec=2)):
        with pytest.raises(RuntimeError, match="launch failed"):
            _launch(q, q, q, None, out, 8, 1.0, bad)
    wide = torch.zeros(2, 8, 2, 72, dtype=torch.bfloat16, device="cuda")[..., 1:65]  # 2 bytes in
    with pytest.raises(RuntimeError, match="launch failed"):
        _launch(wide, q, q, None, out, 8, 1.0, good._replace(q_vec=8))
    assert good.q_vec == 8 and _plan(8, 8, 64, torch.bfloat16, (alignment(wide), 16, 16)).q_vec == 1
