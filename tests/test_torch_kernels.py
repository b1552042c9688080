"""Port parity: the perturbed-LoRA chain (K2) and the fused int8 + LoRA
matmul (K3), and their routing in ``models.nn.dense``.

On the CPU each wrapper runs its plain version; the JAX side runs its
Pallas kernel in interpret mode (``member_lora_delta`` /
``fused_qlora_dense`` with ``interpret=True``, as tests/test_fused.py and
tests/test_fused_qlora.py run them). Ragged shapes (37 tokens, 48 → 40,
r_l 4, r_e 2), f32; a lane axis of 3 against a JAX ``vmap``. Bound
rtol/atol 1e-5; measured max abs error ≤ 2.9e-6. The CUDA kernels
themselves are held against the plain versions by the ``cuda``-marked tests
(skipped without a card) and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.lora import FactoredDelta as JFD
from hyperscalees_t2i_tpu.models import nn as jnn
from hyperscalees_t2i_tpu.ops.fused_lora import member_lora_delta as jchain
from hyperscalees_t2i_tpu.ops.fused_qlora import fused_qlora_dense as jqlora
from hyperscalees_t2i_tpu.ops.quant import quantize_kernel as jquantize
from hyperscalees_t2i_tpu_torch.lora import FactoredDelta
from hyperscalees_t2i_tpu_torch.models import nn as tnn
from hyperscalees_t2i_tpu_torch.ops.fused_lora import member_lora_delta, member_lora_delta_reference
from hyperscalees_t2i_tpu_torch.ops.fused_qlora import fused_qlora_dense, fused_qlora_matmul, fused_qlora_reference
from hyperscalees_t2i_tpu_torch.weights.from_jax import tree_from_numpy

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
T, DIN, DOUT, RL, RE, LANES = 37, 48, 40, 4, 2, 3
LANE_AXES = JFD(None, 0, 0, 0)  # w shared, one (u, v, c) per lane


def _factor(r, m, n, lanes=0):
    sh = (lanes,) if lanes else ()
    return JFD(
        jnp.asarray(r.normal(size=(m, n)) / np.sqrt(m), jnp.float32),
        jnp.asarray(r.normal(size=(*sh, m, RE)), jnp.float32),
        jnp.asarray(r.normal(size=(*sh, n, RE)), jnp.float32),
        jnp.asarray(r.uniform(-0.1, 0.1, size=sh), jnp.float32),
    )


def _inputs(seed, lanes=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=((lanes, T, DIN) if lanes else (T, DIN))).astype(np.float32)
    a, b = _factor(r, DIN, RL, lanes), _factor(r, RL, DOUT, lanes)
    qk = jquantize(jnp.asarray(r.normal(size=(DIN, DOUT)) / np.sqrt(DIN), jnp.float32))
    return x, a, b, qk


def _port(tree):
    return tree_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def test_k3_plain_matches_jax_interpret():
    x, a, b, qk = _inputs(0)
    j = jqlora(jnp.asarray(x), qk, {"a": a, "b": b}, 2.0, interpret=True)
    t = fused_qlora_dense(torch.from_numpy(x), _port(qk), {"a": _port(a), "b": _port(b)}, 2.0)
    assert t.shape == (T, DOUT)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_k3_lanes_match_jax_vmap():
    x, a, b, qk = _inputs(1, LANES)
    j = jax.vmap(lambda xx, aa, bb: jqlora(xx, qk, {"a": aa, "b": bb}, 1.5, interpret=True),
                 in_axes=(0, LANE_AXES, LANE_AXES))(jnp.asarray(x), a, b)
    t = fused_qlora_dense(torch.from_numpy(x.reshape(LANES * T, DIN)), _port(qk),
                          {"a": _port(a), "b": _port(b)}, 1.5)
    np.testing.assert_allclose(t.numpy().reshape(LANES, T, DOUT), np.asarray(j), **TOL)


def test_k2_plain_matches_jax_interpret():
    x, a, b, _ = _inputs(2)
    j = jchain(jnp.asarray(x), a, b, 2.0, interpret=True)
    t = member_lora_delta(torch.from_numpy(x), _port(a), _port(b), 2.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_k2_lanes_match_jax_vmap():
    x, a, b, _ = _inputs(3, LANES)
    j = jax.vmap(lambda xx, aa, bb: jchain(xx, aa, bb, 0.5, interpret=True),
                 in_axes=(0, LANE_AXES, LANE_AXES))(jnp.asarray(x), a, b)
    t = member_lora_delta(torch.from_numpy(x.reshape(LANES * T, DIN)), _port(a), _port(b), 0.5)
    np.testing.assert_allclose(t.numpy().reshape(LANES, T, DOUT), np.asarray(j), **TOL)


@pytest.mark.parametrize("base", ["float", "int8"])
def test_dense_routes_factored_leaves_like_jax(base):
    """``nn.dense`` with both factors factored: K3 over an int8 node, the
    float matmul plus K2 over a float node — against the JAX ``nn.dense``
    (its XLA composition on the CPU)."""
    x, a, b, qk = _inputs(4)
    r = np.random.default_rng(5)
    w = jnp.asarray(r.normal(size=(DIN, DOUT)) / np.sqrt(DIN), jnp.float32)
    node = {"kernel": w} if base == "float" else {"kernel_q8": jquantize(w)}
    node["bias"] = jnp.asarray(r.normal(size=(DOUT,)), jnp.float32)
    x3 = x.reshape(1, T, DIN)
    j = jnn.dense(node, jnp.asarray(x3), {"a": a, "b": b}, 2.0)
    t = tnn.dense(_port(node), torch.from_numpy(x3), {"a": _port(a), "b": _port(b)}, 2.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_dense_with_one_raw_factor_composes_like_jax():
    x, a, b, qk = _inputs(6)
    raw_b = b.w
    j = jnn.dense({"kernel_q8": qk}, jnp.asarray(x), {"a": a, "b": raw_b}, 2.0)
    t = tnn.dense({"kernel_q8": _port(qk)}, torch.from_numpy(x), {"a": _port(a), "b": _port(raw_b)}, 2.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _meta_factor(m, n):
    return FactoredDelta(torch.empty(m, n, device="meta"), torch.empty(m, RE, device="meta"),
                         torch.empty(n, RE, device="meta"), torch.empty((), device="meta"))


def test_wrappers_refuse_non_cpu_tensors_without_a_launch():
    """A tensor off the CPU takes the kernel or raises — never the plain
    version (a meta tensor stands in for one here)."""
    x = torch.empty(T, DIN, device="meta")
    a, b = _meta_factor(DIN, RL), _meta_factor(RL, DOUT)
    q8 = torch.empty(DIN, DOUT, dtype=torch.int8, device="meta")
    scale = torch.empty(1, DOUT, device="meta")
    before = (member_lora_delta.launches, fused_qlora_matmul.launches)
    with pytest.raises(ValueError):
        member_lora_delta(x, a, b, 1.0)
    with pytest.raises(ValueError):
        fused_qlora_matmul(x, q8, scale, a, b, 1.0)
    assert (member_lora_delta.launches, fused_qlora_matmul.launches) == before


def _card_inputs(lanes, xdt, ndt):
    g = torch.Generator(device="cuda").manual_seed(0)
    n = max(lanes, 1)

    def fd(m, k):
        sh = (lanes,) if lanes else ()
        return FactoredDelta(torch.randn(m, k, generator=g, device="cuda") / m ** 0.5,
                             torch.randn(*sh, m, RE, generator=g, device="cuda").to(ndt),
                             torch.randn(*sh, k, RE, generator=g, device="cuda").to(ndt),
                             torch.rand(sh, generator=g, device="cuda") * 0.2 - 0.1)

    x = torch.randn(n * T, DIN, generator=g, device="cuda").to(xdt)
    q8 = torch.randint(-127, 128, (DIN, DOUT), generator=g, device="cuda", dtype=torch.int8)
    scale = torch.rand(1, DOUT, generator=g, device="cuda") * 0.01
    return x, fd(DIN, RL), fd(RL, DOUT), q8, scale


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [0, LANES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_versions_on_the_card(lanes, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dt = getattr(torch, dtype)
    x, a, b, q8, scale = _card_inputs(lanes, dt, dt)
    tol = 2 ** -7 if dt == torch.bfloat16 else 1e-5
    for out, ref in ((member_lora_delta(x, a, b, 2.0), member_lora_delta_reference(x, a, b, 2.0)),
                     (fused_qlora_matmul(x, q8, scale, a, b, 2.0), fused_qlora_reference(x, q8, scale, a, b, 2.0))):
        torch.cuda.synchronize()
        ref = ref.float()
        assert float((out.float() - ref).abs().max()) <= tol * float(ref.abs().max())


def test_kernel_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """K2 and K3 include ``csrc/lora_chain.cuh``, K1 and K3 ``csrc/int8_tile.cuh``,
    and both headers (and K2 and K4 themselves) include ``int8_mma.cuh``:
    editing a header must rebuild every kernel that includes it, and an
    installed package must ship them."""
    from hyperscalees_t2i_tpu_torch.ops import _build

    for name in ("fused_qlora.cu", "lora_chain.cu", "int8_matmul.cu", "decode_attention.cu", "lora_chain.cuh",
                 "int8_tile.cuh", "int8_mma.cuh"):
        (tmp_path / name).write_bytes((_build.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    assert [p.name for p in _build.source_files("fused_qlora")] == [
        "fused_qlora.cu", "lora_chain.cuh", "int8_mma.cuh", "int8_tile.cuh"]
    assert [p.name for p in _build.source_files("int8_matmul")] == ["int8_matmul.cu", "int8_tile.cuh", "int8_mma.cuh"]
    assert [p.name for p in _build.source_files("lora_chain")] == ["lora_chain.cu", "lora_chain.cuh", "int8_mma.cuh"]
    assert [p.name for p in _build.source_files("decode_attention")] == ["decode_attention.cu", "int8_mma.cuh"]
    names = ("fused_qlora", "lora_chain", "int8_matmul", "decode_attention")
    for header, rebuilt in (("lora_chain.cuh", {"fused_qlora", "lora_chain"}),
                            ("int8_tile.cuh", {"fused_qlora", "int8_matmul"}),
                            ("int8_mma.cuh", {"fused_qlora", "int8_matmul", "lora_chain", "decode_attention"})):
        before = {n: _build.library_path(n) for n in names}
        with open(tmp_path / header, "a") as f:
            f.write("\n// edited\n")
        assert {n for n in names if _build.library_path(n) != before[n]} == rebuilt, header
    pyproject = (_build.PKG_DIR.parent / "pyproject.toml").read_text()
    assert '"csrc/*.cuh"' in pyproject
