"""Port parity: the layer primitives of models/nn.py, float and int8.

Same numpy inputs through the JAX package and the PyTorch port on the CPU,
in f32. Bound rtol/atol 1e-4 (the primitives' bound); measured max abs
error 7.6e-6, in the int8 dense case whose outputs are of order 10 (f32
summation order in the matmuls and convolutions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.models import nn as jnn
from hyperscalees_t2i_tpu.ops.quant import quantize_kernel as jquantize
from hyperscalees_t2i_tpu_torch.models import nn as tnn
from hyperscalees_t2i_tpu_torch.weights.from_jax import tree_from_numpy

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _node(kernel, bias, quant):
    """The same node for both packages: numpy tree (float or JAX-quantized)."""
    node = {"kernel": kernel} if not quant else {
        "kernel_q8": jax.tree_util.tree_map(np.array, jquantize(jnp.asarray(kernel)))
    }
    if bias is not None:
        node["bias"] = bias
    return node


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return tree_from_numpy(tree, "cpu")


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("with_lora", [False, True])
def test_dense(quant, with_lora):
    r = _rng(0)
    node = _node(r.normal(size=(24, 20)).astype(np.float32), r.normal(size=20).astype(np.float32), quant)
    x = r.normal(size=(3, 5, 24)).astype(np.float32)
    lora = None
    if with_lora:
        lora = {"a": r.normal(size=(24, 4)).astype(np.float32), "b": r.normal(size=(4, 20)).astype(np.float32)}
    j = jnn.dense(_j(node), jnp.asarray(x), None if lora is None else _j(lora), 2.0)
    t = tnn.dense(_t(node), torch.from_numpy(x), None if lora is None else _t(lora), 2.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    # the module form over the same node gives the same result
    m = tnn.Dense(_t(node))(torch.from_numpy(x), None if lora is None else _t(lora), 2.0)
    np.testing.assert_allclose(m.numpy(), t.numpy(), rtol=0, atol=0)


def test_dense_lane_stacked_lora_applies_each_adapter_to_its_rows():
    r = _rng(1)
    node = {"kernel": torch.from_numpy(r.normal(size=(12, 10)).astype(np.float32))}
    x = torch.from_numpy(r.normal(size=(6, 7, 12)).astype(np.float32))  # 3 lanes x 2 rows
    lanes = [{"a": torch.from_numpy(r.normal(size=(12, 3)).astype(np.float32)),
              "b": torch.from_numpy(r.normal(size=(3, 10)).astype(np.float32))} for _ in range(3)]
    stacked = {f: torch.stack([l[f] for l in lanes]) for f in ("a", "b")}
    y = tnn.dense(node, x, stacked, 0.5)
    for i, l in enumerate(lanes):
        np.testing.assert_allclose(
            y[2 * i:2 * i + 2].numpy(), tnn.dense(node, x[2 * i:2 * i + 2], l, 0.5).numpy(), rtol=1e-6, atol=1e-6
        )


# (kh, kw, cin, cout, stride, groups, H) — 1×1, 3×3, depthwise, 2×2 patch, 3×3 stride 2
CONVS = [(1, 1, 8, 12, 1, 1, 6), (3, 3, 8, 12, 1, 1, 6), (3, 3, 1, 8, 1, 8, 6),
         (2, 2, 8, 12, 2, 1, 6), (3, 3, 4, 6, 2, 1, 7)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("kh,kw,cin,cout,stride,groups,H", CONVS)
def test_conv2d(kh, kw, cin, cout, stride, groups, H, quant):
    r = _rng(2)
    node = _node(r.normal(size=(kh, kw, cin, cout)).astype(np.float32) / 3,
                 r.normal(size=cout).astype(np.float32), quant)
    C = cin * groups
    x = r.normal(size=(2, H, H, C)).astype(np.float32)
    j = jnn.conv2d(_j(node), jnp.asarray(x), stride=stride, groups=groups)
    t = tnn.conv2d(_t(node), torch.from_numpy(x), stride=stride, groups=groups)
    assert t.shape == tuple(j.shape)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_linear_attention_and_masked_attention():
    r = _rng(3)
    q, k, v = (r.normal(size=(2, 9, 3, 4)).astype(np.float32) for _ in range(3))
    j = jnn.linear_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = tnn.linear_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    kc, vc = (r.normal(size=(2, 5, 3, 4)).astype(np.float32) for _ in range(2))
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    j = jnn.attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), mask=jnp.asarray(mask))
    t = tnn.attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_norms_embeddings_and_depth_to_space():
    r = _rng(4)
    x = r.normal(size=(2, 5, 16)).astype(np.float32)
    scale = r.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(tnn.layer_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jnn.layer_norm(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(tnn.rms_norm(torch.from_numpy(x), {"scale": torch.from_numpy(scale)}).numpy(),
                               np.asarray(jnn.rms_norm(jnp.asarray(x), {"scale": jnp.asarray(scale)})), **TOL)
    t = np.array([0.0, 0.5, 0.9996], np.float32)
    np.testing.assert_allclose(tnn.timestep_embedding(torch.from_numpy(t), 17).numpy(),
                               np.asarray(jnn.timestep_embedding(jnp.asarray(t), 17)), **TOL)
    y = r.normal(size=(2, 3, 4, 12)).astype(np.float32)
    np.testing.assert_array_equal(tnn.depth_to_space(torch.from_numpy(y), 2).numpy(),
                                  np.asarray(jnn.depth_to_space(jnp.asarray(y), 2)))


@pytest.mark.parametrize("quant", [False, True])
def test_glumb_conv_and_mlp_embedder(quant):
    r = _rng(5)
    p = {
        "conv_inverted": _node(r.normal(size=(1, 1, 8, 20)).astype(np.float32) / 3, r.normal(size=20).astype(np.float32), quant),
        "conv_depth": _node(r.normal(size=(3, 3, 1, 20)).astype(np.float32) / 3, r.normal(size=20).astype(np.float32), quant),
        "conv_point": _node(r.normal(size=(1, 1, 10, 8)).astype(np.float32) / 3, None, quant),
    }
    x = r.normal(size=(2, 12, 8)).astype(np.float32)
    j = jnn.glumb_conv(_j(p), jnp.asarray(x), (3, 4))
    np.testing.assert_allclose(tnn.glumb_conv(_t(p), torch.from_numpy(x), (3, 4)).numpy(), np.asarray(j), **TOL)
    m = {"linear_1": _node(r.normal(size=(6, 8)).astype(np.float32), r.normal(size=8).astype(np.float32), quant),
         "linear_2": _node(r.normal(size=(8, 8)).astype(np.float32), r.normal(size=8).astype(np.float32), quant)}
    e = r.normal(size=(3, 6)).astype(np.float32)
    np.testing.assert_allclose(tnn.mlp_embedder(_t(m), torch.from_numpy(e)).numpy(),
                               np.asarray(jnn.mlp_embedder(_j(m), jnp.asarray(e))), **TOL)
