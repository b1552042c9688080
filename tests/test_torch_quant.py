"""Port parity: int8 quantization and the int8 dequant-matmul (kernel K1).

The same numpy inputs go through the JAX package (the Pallas kernel in
interpret mode, as tests/test_quant.py runs it) and the PyTorch port (the
kernel's plain version, which is what a CPU tensor takes). The CUDA kernel
itself is checked by the ``cuda``-marked test, which skips without a card,
and by ``chip_smoke.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.ops import quant as jquant
from hyperscalees_t2i_tpu.ops.quant_mm import int8_matmul as jint8_matmul
from hyperscalees_t2i_tpu_torch.ops import quant as tquant
from hyperscalees_t2i_tpu_torch.ops.quant_mm import _plan, dequant_matmul, int8_matmul, int8_matmul_reference

torch.set_num_threads(1)


def _np(x):
    return np.array(x)  # a writable copy, so torch.from_numpy can share it


@pytest.mark.parametrize("shape", [(48, 40), (3, 24, 16), (3, 3, 8, 12), (2, 1, 1, 8, 16)])
def test_quantize_kernel_matches_jax_bitwise(shape):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jq = jquant.quantize_kernel(jnp.asarray(w))
    tq = tquant.quantize_kernel(torch.from_numpy(w))
    np.testing.assert_array_equal(tq["q8"].numpy(), _np(jq["q8"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), _np(jq["scale"]))
    np.testing.assert_array_equal(
        tquant.dequantize_kernel(tq, torch.float32).numpy(),
        _np(jquant.dequantize_kernel(jq, jnp.float32)),
    )


def test_dequantize_block_scales_matches_jax():
    rng = np.random.default_rng(1)
    q8 = rng.integers(-127, 128, size=(64, 24)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, size=(2, 24)).astype(np.float32)  # 2 blocks of 32
    j = _np(jquant.dequantize_kernel({"q8": jnp.asarray(q8), "scale": jnp.asarray(scale)}, jnp.float32))
    t = tquant.dequantize_kernel({"q8": torch.from_numpy(q8), "scale": torch.from_numpy(scale)}, torch.float32)
    np.testing.assert_array_equal(t.numpy(), j)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    y = dequant_matmul(torch.from_numpy(x), {"q8": torch.from_numpy(q8), "scale": torch.from_numpy(scale)})
    np.testing.assert_allclose(y.numpy(), x @ j, rtol=1e-5, atol=1e-5)


def test_quantize_tree_floor_counts_the_stacked_tensor():
    """A stacked [L, din, dout] leaf is quantized when L·din·dout clears the
    floor even though one layer alone does not (JAX quant.py:111)."""
    rng = np.random.default_rng(2)
    tree = {
        "stacked": {"kernel": rng.normal(size=(4, 128, 160)).astype(np.float32)},  # 81920 >= 65536
        "small": {"kernel": rng.normal(size=(128, 160)).astype(np.float32), "bias": np.zeros(160, np.float32)},
    }
    jt = jquant.maybe_quantize_tree({k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in tree.items()}, "int8")
    tt = tquant.maybe_quantize_tree({k: {n: torch.from_numpy(v) for n, v in d.items()} for k, d in tree.items()}, "int8")
    assert set(jt["stacked"]) == set(tt["stacked"]) == {"kernel_q8"}
    assert set(jt["small"]) == set(tt["small"]) == {"kernel", "bias"}
    np.testing.assert_array_equal(tt["stacked"]["kernel_q8"]["q8"].numpy(), _np(jt["stacked"]["kernel_q8"]["q8"]))
    assert tquant.maybe_quantize_tree(tt, "off") is tt


@pytest.mark.parametrize("lead", [(37,), (2, 5), (1,)])
def test_int8_matmul_matches_jax_pallas_interpret(lead):
    """Ragged token counts (37 over a block of 16, as the TPU kernel pads).
    Measured max abs error 3.6e-7 (f32 summation order); bound 1e-5."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(48, 40)) * 0.1).astype(np.float32)
    qk = jquant.quantize_kernel(jnp.asarray(w))
    x = rng.normal(size=(*lead, 48)).astype(np.float32)
    ref = _np(jint8_matmul(jnp.asarray(x), qk["q8"], qk["scale"], interpret=True, block_t=16))
    before = int8_matmul.launches
    out = int8_matmul(torch.from_numpy(x), torch.from_numpy(_np(qk["q8"])), torch.from_numpy(_np(qk["scale"])))
    assert int8_matmul.launches == before  # the CPU takes the plain version, no launch
    assert out.shape == (*lead, 40) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_int8_matmul_reference_casts_to_x_dtype():
    rng = np.random.default_rng(4)
    q8 = torch.from_numpy(rng.integers(-127, 128, size=(16, 8)).astype(np.int8))
    scale = torch.full((1, 8), 0.01)
    x = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32)).to(torch.bfloat16)
    y = int8_matmul(x, q8, scale)
    assert y.dtype == torch.bfloat16
    exp = (x.float() @ (q8.float() * scale)).to(torch.bfloat16)
    assert torch.equal(y, exp)
    assert torch.equal(y, int8_matmul_reference(x, q8, scale))


# (M, K, N) of every K1 call site on the port's paths (chip_smoke.K1_SHAPES)
K1_SITE_SHAPES = [
    (1, 256, 2240), (1, 2240, 2240), (1, 2240, 13440), (32, 2304, 2240), (32, 2240, 2240),
    (1024, 2240, 2240), (1024, 2240, 11200), (1024, 5600, 2240), (1024, 32, 2240), (1024, 2240, 32),
    (1024, 1024, 3072), (1024, 1024, 1024), (1024, 1024, 4096), (1024, 2048, 1024),
    (4096, 1024, 3072), (4096, 1024, 1024), (4096, 1024, 4096), (4096, 2048, 1024),
    (49, 3072, 768), (50, 768, 768), (50, 768, 3072), (50, 3072, 768), (1, 768, 512),
    (256, 588, 1280), (257, 1280, 1280), (257, 1280, 5120), (257, 5120, 1280), (1, 1280, 1024),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N", sorted({(k, n) for _, k, n in K1_SITE_SHAPES}))
def test_int8_matmul_plan_sum_order_ignores_m_and_copies_respect_alignment(K, N, dtype):
    """The kernel's batch invariance rests on its plan: the tile may follow
    M, the depth of a stage of the k sum (``bk``, which the C entry refuses
    unless it is the route's own) may not. And a 16-byte copy of x is
    planned only where K % 8 and x's address allow it (8-byte: K % 4 and
    8-byte alignment), a 16-byte copy of q8 only where N % 16 and q8's
    address allow it."""
    depths = set()
    for M in (1, 2, 50, 257, 1024, 4096):
        for x_ptr in (0, 8, 2, 4096 + 2 * K):  # aligned, 8-aligned, 2-aligned, one row in
            for q_ptr in (0, 4):
                p = _plan(M, K, N, dtype, x_ptr, q_ptr)
                depths.add(p.bk)
                if dtype == torch.float32:
                    assert p.tile == (0 if M <= 8 else 1) and p.a_vec == p.b_vec == 0
                    continue
                assert p.tile in (2, 3, 4)
                assert p.a_vec in (1, 4, 8) and p.b_vec in (1, 16)
                if p.a_vec == 8:
                    assert K % 8 == 0 and x_ptr % 16 == 0
                if p.a_vec == 4:
                    assert K % 4 == 0 and x_ptr % 8 == 0
                if p.b_vec == 16:
                    assert N % 16 == 0 and q_ptr % 16 == 0
    assert depths == {64 if dtype == torch.bfloat16 else 32}
    # the widest copy is taken where it is allowed
    p = _plan(1024, K, N, dtype, 0, 0)
    if dtype == torch.bfloat16:
        assert p.a_vec == (8 if K % 8 == 0 else 4 if K % 4 == 0 else 1)
        assert p.b_vec == (16 if N % 16 == 0 else 1)


def test_int8_matmul_plan_fills_the_card():
    """The 128×128 tile only from 0.9 of a wave of 132 SMs; at M ≤ 50 the
    16×64 tile; CLIP-H's M = 257 takes 64×64 (≥ 100 blocks) except at N =
    5120, where 128×128 gives 120 blocks."""
    bf = torch.bfloat16
    assert _plan(1024, 2240, 2240, bf).tile == 2  # 8 × 18 = 144 blocks
    assert _plan(257, 1280, 5120, bf).tile == 2   # 3 × 40 = 120
    assert _plan(1024, 1024, 1024, bf).tile == 3  # 8 × 8 = 64 blocks at 128×128
    assert _plan(257, 1280, 1280, bf).tile == 3   # 5 × 20 = 100
    for M, K, N in ((1, 768, 512), (32, 2240, 2240), (50, 768, 768), (1024, 2240, 32)):
        assert _plan(M, K, N, bf).tile == 4
    with pytest.raises(TypeError):
        _plan(4, 8, 8, torch.float16)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,K,N,offset", [
    (1, 256, 2240, 0), (37, 48, 40, 0), (1024, 2240, 130, 0),
    (257, 588, 1280, 0), (50, 768, 768, 0), (1, 2240, 2240, 0), (1024, 32, 2240, 0), (1024, 2240, 32, 0),
    (256, 588, 1280, 1),  # x[1:] of a contiguous tensor: rows start 1176 bytes in, 8-byte aligned
])
def test_int8_matmul_kernel_matches_reference_on_card(dtype, M, K, N, offset):
    """The CUDA kernel against its plain version on the card (ragged M and N
    edges, K = 588 and K = 32, N = 32, a view with a storage offset); bf16
    within two bf16 ulps of the largest output, f32 1e-5."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    x = torch.randn(M + offset, K, generator=g, device="cuda").to(dt)[offset:]
    assert x.is_contiguous() and x.storage_offset() == offset * K
    q8 = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
    scale = torch.rand(1, N, generator=g, device="cuda") * 0.01
    before = int8_matmul.launches
    out = int8_matmul(x, q8, scale)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    ref = int8_matmul_reference(x, q8, scale).float()
    tol = (2 ** -7 if dt == torch.bfloat16 else 1e-5) * float(ref.abs().max())
    assert float((out.float() - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("K,N", [(2240, 2240), (588, 1280), (768, 3072)])
def test_int8_matmul_kernel_is_batch_invariant_bitwise_on_card(dtype, K, N):
    """Rows of one call equal, bit for bit, the same rows in a call of
    another size: the tile follows M (different kernels at M = 1, 2, 50,
    257, 1024), the order of the k sum does not."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(1)
    dt = getattr(torch, dtype)
    x = torch.randn(1024, K, generator=g, device="cuda").to(dt)
    q8 = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
    scale = torch.rand(1, N, generator=g, device="cuda") * 0.01
    full = int8_matmul(x, q8, scale)
    for lo, hi in ((0, 1), (0, 2), (0, 50), (0, 257), (700, 701), (1023, 1024)):
        assert torch.equal(int8_matmul(x[lo:hi], q8, scale), full[lo:hi]), (lo, hi)
