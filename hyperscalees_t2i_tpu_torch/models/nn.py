"""Layer primitives on tensors, and the modules that hold the frozen base.

Port of ``hyperscalees_t2i_tpu/models/nn.py``. Layouts are the JAX
package's: NHWC activations, ``[din, dout]`` dense kernels, HWIO conv
kernels, per-output-channel int8 scales as in ``ops/quant.py``. A parameter
*node* is a dict ``{"kernel": w}`` or ``{"kernel_q8": {"q8", "scale"}}``
plus an optional ``"bias"``, exactly the JAX tree node.

:class:`Dense` and :class:`Conv` are the ``nn.Module`` form of one node: the
frozen weights are buffers (int8 ``q8`` + f32 ``scale``, or float). A conv
that does not route to the int8 matmul keeps its kernel in OIHW for
``F.conv2d``, converted once when the module is built.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..lora import FactoredDelta, fused_lora_delta, lane_matmul, lora_delta, matmul_factored
from ..ops.fused_qlora import conv_kernel_q8_matmul, fused_qlora_applies, fused_qlora_dense
from ..ops.quant import dequantize_kernel
from ..ops.quant_mm import dequant_matmul
from ..utils import threefry

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers: the JAX package's, key for key (a key is a ``utils.threefry``
# key; the leaves land on its device)
# ---------------------------------------------------------------------------

def dense_init(key: torch.Tensor, d_in: int, d_out: int, bias: bool = True, std: Optional[float] = None) -> Params:
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    p = {"kernel": threefry.normal(key, (d_in, d_out)) * std}
    if bias:
        p["bias"] = torch.zeros(d_out, device=key.device)
    return p


def stacked_dense_init(key: torch.Tensor, L: int, d_in: int, d_out: int, bias: bool = True,
                       std: Optional[float] = None) -> Params:
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    p = {"kernel": threefry.normal(key, (L, d_in, d_out)) * std}
    if bias:
        p["bias"] = torch.zeros(L, d_out, device=key.device)
    return p


def conv_init(key: torch.Tensor, kh: int, kw: int, c_in: int, c_out: int, bias: bool = True,
              groups: int = 1) -> Params:
    fan_in = kh * kw * c_in // groups
    p = {"kernel": threefry.normal(key, (kh, kw, c_in // groups, c_out)) / math.sqrt(fan_in)}
    if bias:
        p["bias"] = torch.zeros(c_out, device=key.device)
    return p


def norm_init(dim: int, device: torch.device, scale: bool = True, bias: bool = True) -> Params:
    p = {}
    if scale:
        p["scale"] = torch.ones(dim, device=device)
    if bias:
        p["bias"] = torch.zeros(dim, device=device)
    return p


def mlp_embedder_init(key: torch.Tensor, d_in: int, d_out: int) -> Params:
    k1, k2 = threefry.split(key)
    return {"linear_1": dense_init(k1, d_in, d_out), "linear_2": dense_init(k2, d_out, d_out)}


def glumb_conv_init(key: torch.Tensor, dim: int, ratio: float = 2.5) -> Params:
    hidden = int(round(dim * ratio))
    k1, k2, k3 = threefry.split(key, 3)
    return {
        "conv_inverted": conv_init(k1, 1, 1, dim, hidden * 2),
        "conv_depth": conv_init(k2, 3, 3, hidden * 2, hidden * 2, groups=hidden * 2),
        "conv_point": conv_init(k3, 1, 1, hidden, dim, bias=False),
    }


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def dense(p: Params, x: torch.Tensor, lora: Optional[Params] = None, lora_scale: float = 1.0,
          tp: Optional[Any] = None) -> torch.Tensor:
    """``y = x @ W (+ b) (+ lora_scale·(x@A)@B)``; ``W`` float or int8, the
    adapter one ``{"a", "b"}`` leaf or a lane-stacked batch
    (:func:`~..lora.lora_delta`).

    ``tp`` is the node's tensor-parallel plan (``parallel.tp.TPShard``):
    ``p`` holds this rank's chunk of a sharded kernel or bias. A
    column-parallel kernel's product is gathered on the feature axis; a
    row-parallel one takes the local input slice, multiplied in f32, and
    its partial sums are all-reduced and rounded to x's dtype once; a
    sharded bias is gathered. The output is whole either way, and the
    adapter applies to the whole x.

    Under ES training (``pop_fuse``) the factors arrive as
    ``lora.FactoredDelta``: an int8 per-channel node with both factors
    factored runs the fused kernel K3 (``ops.fused_qlora``), a float node
    the chain kernel K2 for the delta (``lora.fused_lora_delta``); other
    mixes compose the dequant or float matmul with ``matmul_factored``."""
    if tp is not None and tp.kernel == -1:
        y = tp.gather(x @ p["kernel"].to(x.dtype))
    elif tp is not None and tp.kernel == -2:
        y = tp.reduce(tp.local_in(x).to(torch.float32) @ p["kernel"].to(torch.float32)).to(x.dtype)
    elif "kernel" in p:
        y = x @ p["kernel"].to(x.dtype)
    elif lora is not None and fused_qlora_applies(lora):
        y = fused_qlora_dense(x, p["kernel_q8"], lora, lora_scale)
        lora = None  # consumed by the fused resolution
    else:
        y = dequant_matmul(x, p["kernel_q8"])
    if lora is not None:
        if isinstance(lora["a"], FactoredDelta) or isinstance(lora["b"], FactoredDelta):
            y = y + fused_lora_delta(x, lora, lora_scale)
        else:
            y = y + lora_delta(x, lora, lora_scale)
    if "bias" in p:
        y = y + (p["bias"] if tp is None else tp.full_bias(p["bias"])).to(x.dtype)
    return y


def _same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_oihw(x: torch.Tensor, w: torch.Tensor, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """NHWC ``x`` convolved with an OIHW kernel through ``F.conv2d``, with
    ``lax.conv``'s ``"SAME"`` padding (the extra row/column, if any, last)."""
    xc = x.permute(0, 3, 1, 2)
    ph = _same_padding(x.shape[1], w.shape[-2], stride)
    pw = _same_padding(x.shape[2], w.shape[-1], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(xc, w, stride=stride, padding=(ph[0], pw[0]), groups=groups)
    else:
        y = F.conv2d(F.pad(xc, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


def conv2d(p: Params, x: torch.Tensor, stride: int = 1, groups: int = 1, lora: Optional[Params] = None,
           lora_scale: float = 1.0) -> torch.Tensor:
    """NHWC conv with an HWIO kernel node, float or int8, ``"SAME"`` padding,
    and an optional conv LoRA (:func:`conv_lora_delta`): :class:`Conv` built
    for ``p`` and applied once."""
    return Conv(p, stride=stride, groups=groups)(x, lora, lora_scale)


def conv_lora_delta(x: torch.Tensor, leaf: Dict[str, Any], scale: float, stride: int = 1) -> torch.Tensor:
    """PEFT's conv LoRA: an r-channel conv with ``a [kh, kw, cin, r]`` (HWIO,
    ``"SAME"``), then the 1×1 projection ``b [r, cout]``, times ``scale``, in
    x's dtype. ``a`` carries dense ES noise, so it arrives materialized; a
    lane-stacked ``a [n, kh, kw, cin, r]`` applies lane ``i``'s factor to
    the ``i``-th of ``n`` equal row groups of ``x`` (one grouped conv). ``b``
    may be raw, lane-stacked ``[n, r, cout]`` or a ``lora.FactoredDelta``
    (laned or not)."""
    a, b = leaf["a"].to(x.dtype), leaf["b"]
    if a.ndim == 4:
        h = conv_oihw(x, hwio_to_oihw(a), stride)
    else:
        n, kh, kw, cin, r = a.shape
        R, H, W, C = x.shape
        if R % n:
            raise ValueError(f"{R} rows do not split into {n} lanes")
        xg = x.reshape(n, R // n, H, W, C).permute(1, 2, 3, 0, 4).reshape(R // n, H, W, n * C)
        hg = conv_oihw(xg, a.permute(0, 4, 3, 1, 2).reshape(n * r, cin, kh, kw), stride, groups=n)
        Ho, Wo = hg.shape[1:3]
        h = hg.reshape(R // n, Ho, Wo, n, r).permute(3, 0, 1, 2, 4).reshape(R, Ho, Wo, r)
    if isinstance(b, FactoredDelta):
        return matmul_factored(h, b) * scale
    return lane_matmul(h, b.to(x.dtype)) * scale


def layer_norm(x: torch.Tensor, p: Optional[Params] = None, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (population variance); affine only
    when ``p`` carries ``scale``/``bias``."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if p is not None and "scale" in p:
        y = y * p["scale"]
    if p is not None and "bias" in p:
        y = y + p["bias"]
    return y.to(dtype)


def rms_norm(x: torch.Tensor, p: Optional[Params] = None, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    if p is not None and "scale" in p:
        y = y * p["scale"]
    return y.to(dtype)


def group_norm(x: torch.Tensor, p: Optional[Params] = None, groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over NHWC in f32 (the CompVis-VAE normalizer): ``min(groups,
    C)`` groups, lowered until they divide C; population variance."""
    dtype = x.dtype
    B, H, W, C = x.shape
    g = min(groups, C)
    while C % g:
        g -= 1
    xg = x.to(torch.float32).reshape(B, H, W, g, C // g)
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), unbiased=False, keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    if p is not None and "scale" in p:
        y = y * p["scale"]
    if p is not None and "bias" in p:
        y = y + p["bias"]
    return y.to(dtype)


def slice_stacked(p: Params, i: int) -> Params:
    """Layer ``i`` of a layer-stacked dense node (``[depth, din, dout]``
    float kernel or int8 ``q8``/``scale``, ``[depth, dout]`` bias): views,
    no copy."""
    out: Params = {}
    for k, v in p.items():
        out[k] = {"q8": v["q8"][i], "scale": v["scale"][i]} if k == "kernel_q8" else v[i]
    return out


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs ``(x[2j], x[2j+1])`` of ``x [B, S, H, dh]``
    by the angles whose ``cos``/``sin`` are ``[S, dh/2]``."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


MAX_QK_SCALE_MUL = math.log(100.0)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """f32 unit norm over the last axis, ``x · rsqrt(Σx² + 1e-24)``; returns
    f32."""
    x = x.to(torch.float32)
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-24)


def q_l2(q: torch.Tensor, scale_mul_h: torch.Tensor) -> torch.Tensor:
    """``normalize(q) · exp(min(scale_mul, log 100))`` per head (``q
    [..., H, dh]``, ``scale_mul_h [H]``), in q's dtype."""
    sm = torch.exp(torch.clamp(scale_mul_h.to(torch.float32), max=MAX_QK_SCALE_MUL))
    return (l2_normalize(q) * sm[:, None]).to(q.dtype)


def qk_l2(q: torch.Tensor, k: torch.Tensor, scale_mul_h: torch.Tensor):
    """QK-l2 attention's inputs: :func:`q_l2` for q, unit-norm k (the AR
    caches store the normalized k); the softmax scale becomes 1."""
    return q_l2(q, scale_mul_h), l2_normalize(k).to(k.dtype)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0, scale: float = 1.0) -> torch.Tensor:
    """Sinusoidal features ``[B, dim]`` in f32, cos|sin order."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = scale * t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def mlp_embedder(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``linear_2(silu(linear_1(x)))`` with ``p = {"linear_1", "linear_2"}``."""
    return MLPEmbedder(p)(x)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Softmax attention over ``[B, L, H, Dh]`` tensors, as
    ``jax.nn.dot_product_attention`` computes it: f32 logits scaled by
    ``1/sqrt(Dh)``, a ``-1e9`` additive key mask (in q's dtype), f32
    softmax, probabilities cast to v's dtype."""
    logits = torch.einsum("btnh,bsnh->bnts", q.to(torch.float32), k.to(torch.float32))
    logits = logits * (1.0 / math.sqrt(q.shape[-1]))
    if mask is not None:
        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        neg = torch.full((), -1e9, dtype=q.dtype, device=q.device)
        bias = torch.where(mask.bool()[:, None, None, :], zero, neg)
        logits = logits + bias.to(torch.float32)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bnts,bsnh->btnh", probs, v)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """ReLU linear attention over ``[B, L, H, D]`` (Sana's lite attention).

    The products take the operands' values (bf16 on the card) widened to
    f32, which is what bf16 operands with f32 accumulation compute; ``kv``
    is rounded to the compute dtype before the second product, as the JAX
    package does on an accelerator, and the normalizer is f32. In f32
    configurations every step is f32."""
    dtype = q.dtype
    f32 = torch.float32
    q = F.relu(q).to(f32)
    k = F.relu(k).to(f32)
    kv = torch.einsum("blhd,blhe->bhde", k, v.to(f32))
    ksum = k.sum(dim=1)
    num = torch.einsum("blhd,bhde->blhe", q, kv.to(dtype).to(f32))
    den = torch.einsum("blhd,bhd->blh", q, ksum)
    return (num / (den[..., None] + eps)).to(dtype)


def glumb_conv(p: Params, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Gated depthwise mix-FFN over ``[B, L, d]`` tokens on an ``(H, W)``
    grid: :class:`GLUMBConv` built for ``p`` and applied once."""
    return GLUMBConv(p)(x, hw)


def depth_to_space(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[B,H,W,C·f²] → [B,H·f,W·f,C]`` with channels ordered ``(i, j, c)``
    (not ``torch.pixel_shuffle``'s ``(c, i, j)``)."""
    B, H, W, C = x.shape
    c = C // (factor * factor)
    x = x.reshape(B, H, W, factor, factor, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H * factor, W * factor, c)


# ---------------------------------------------------------------------------
# Modules holding one frozen node as buffers
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """One dense node (``[din, dout]`` float kernel or int8 ``q8``/``scale``);
    ``tp`` its tensor-parallel plan once ``parallel.tp.shard_module_tp`` has
    sharded it."""

    def __init__(self, node: Params):
        super().__init__()
        self.tp = None
        if "kernel" in node:
            self.register_buffer("kernel", node["kernel"])
        else:
            self.register_buffer("q8", node["kernel_q8"]["q8"].contiguous())
            self.register_buffer("scale", node["kernel_q8"]["scale"].contiguous())
        if "bias" in node:
            self.register_buffer("bias", node["bias"])

    def node(self) -> Params:
        """The JAX-layout node dict over this module's buffers."""
        p: Params = {}
        if hasattr(self, "kernel"):
            p["kernel"] = self.kernel
        else:
            p["kernel_q8"] = {"q8": self.q8, "scale": self.scale}
        if hasattr(self, "bias"):
            p["bias"] = self.bias
        return p

    def forward(self, x: torch.Tensor, lora: Optional[Params] = None, lora_scale: float = 1.0) -> torch.Tensor:
        return dense(self.node(), x, lora, lora_scale, tp=self.tp)


class Conv(nn.Module):
    """One conv node (``"SAME"`` padding); ``stride`` and ``groups`` are
    fixed per call site. An int8 1×1 stride-1 or p×p stride-p conv keeps its
    HWIO ``q8`` for the dequant-matmul route; every other conv keeps its
    kernel in OIHW (int8 ``q8`` + ``scale [cout,1,1,1]``, or float) for
    ``F.conv2d``. ``tp`` is its tensor-parallel plan (:func:`dense`'s; a
    grouped conv's column-parallel kernel takes its own input channels)."""

    def __init__(self, node: Params, stride: int = 1, groups: int = 1):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.tp = None
        if "kernel" in node:
            kh, kw = node["kernel"].shape[:2]
            self.register_buffer("kernel_oihw", hwio_to_oihw(node["kernel"]))
        else:
            q8, scale = node["kernel_q8"]["q8"], node["kernel_q8"]["scale"]
            kh, kw, _, cout = q8.shape
            if tuple(scale.shape) != (1, 1, 1, cout):
                raise ValueError(f"conv nodes take per-channel scales [1,1,1,{cout}], got {tuple(scale.shape)}")
            matmul_route = groups == 1 and (kh == kw == 1 and stride == 1 or kh == kw == stride)
            if matmul_route:
                self.register_buffer("q8", q8.contiguous())
                self.register_buffer("scale", scale.contiguous())
            else:
                self.register_buffer("q8_oihw", hwio_to_oihw(q8))
                self.register_buffer("scale_oihw", scale.reshape(cout, 1, 1, 1).contiguous())
        if "bias" in node:
            self.register_buffer("bias", node["bias"])

    def forward(self, x: torch.Tensor, lora: Optional[Params] = None, lora_scale: float = 1.0) -> torch.Tensor:
        """The conv of ``x``, plus the conv LoRA ``lora`` (``{"a", "b"}``,
        :func:`conv_lora_delta`) where given and the conv is not grouped,
        before the bias (the JAX package's order)."""
        y = None
        tp = self.tp
        if tp is not None and tp.kernel is not None:
            w = self.kernel_oihw
            if tp.kernel == -1:  # the local output channels; a grouped conv's own input channels
                xin = tp.local_in(x) if self.groups > 1 else x
                y = tp.gather(conv_oihw(xin, w.to(x.dtype), self.stride, self.groups))
            else:
                y = tp.reduce(conv_oihw(tp.local_in(x).to(torch.float32), w.to(torch.float32), self.stride,
                                        self.groups)).to(x.dtype)
        elif hasattr(self, "q8"):
            y = conv_kernel_q8_matmul(
                x, {"q8": self.q8, "scale": self.scale}, self.stride, "SAME", self.groups
            )
        if y is None:
            if hasattr(self, "kernel_oihw"):
                w = self.kernel_oihw.to(x.dtype)
            elif hasattr(self, "q8_oihw"):
                w = (self.q8_oihw.to(torch.float32) * self.scale_oihw).to(x.dtype)
            else:  # a patch conv whose grid the patch does not divide
                w = hwio_to_oihw(dequantize_kernel({"q8": self.q8, "scale": self.scale}, x.dtype))
            y = conv_oihw(x, w, self.stride, self.groups)
        if lora is not None and self.groups == 1:
            y = y + conv_lora_delta(x, lora, lora_scale, self.stride)
        if hasattr(self, "bias"):
            y = y + (self.bias if tp is None else tp.full_bias(self.bias)).to(x.dtype)
        return y


class MLPEmbedder(nn.Module):
    """``linear_2(silu(linear_1(x)))`` (the time and guidance embedders)."""

    def __init__(self, node: Params):
        super().__init__()
        self.linear_1 = Dense(node["linear_1"])
        self.linear_2 = Dense(node["linear_2"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class GLUMBConv(nn.Module):
    """Gated inverted-bottleneck mix-FFN: 1×1 conv, SiLU, depthwise 3×3 conv
    (groups = its width), split, ``y · silu(gate)``, 1×1 conv."""

    def __init__(self, node: Params):
        super().__init__()
        self.conv_inverted = Conv(node["conv_inverted"])
        depth = node["conv_depth"]
        width = (depth["kernel"] if "kernel" in depth else depth["kernel_q8"]["q8"]).shape[-1]
        self.conv_depth = Conv(depth, groups=width)
        self.conv_point = Conv(node["conv_point"])

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        B, L, d = x.shape
        y = F.silu(self.conv_inverted(x.reshape(B, hw[0], hw[1], d)))
        y, gate = torch.chunk(self.conv_depth(y), 2, dim=-1)
        return self.conv_point(y * F.silu(gate)).reshape(B, L, d)
