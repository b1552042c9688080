"""The ``jax.random`` stream in torch: Threefry-2x32 keys and the draws the
JAX package makes from them.

A key is a ``[..., 2]`` int64 tensor holding two uint32 words, on the device
the draws are made on (``torch.uint32`` cannot add or shift on the CPU, so
every add, shift and rotation is masked to 32 bits in int64). Leading
dimensions are a batch of keys: each key draws its own stream, which is what
``jax.vmap`` over a key gives. The semantics are those of jax 0.9 with
``jax_threefry_partitionable`` on (its default) and the low-range Gumbel
(``jax_high_dynamic_range_gumbel`` off, its default):

- ``fold_in(key, d) = threefry2x32(key, (0, uint32(d)))``;
- ``split(key, n)[i] = threefry2x32(key, (0, i)) = fold_in(key, i)``;
- element ``i`` (flat, row-major) of a draw of ``shape`` hashes the count
  ``(i >> 32, i & 0xFFFFFFFF)``, and its 32 random bits are the xor of the
  two output words. Element ``i`` depends only on ``(key, i)``, so a draw is
  made in chunks of the flat index (bounded int64 temporaries) and equals
  the whole draw exactly.

Bits and uniforms equal jax's bit for bit. Normals go through XLA's float32
``ErfInv`` polynomial (not ``torch.erfinv``, which differs by up to 2e-5);
they and the Gumbels differ from jax's only where ``log1p``/``log`` round
differently (within 1e-6 for |z| ≤ 5.5, measured by
``tests/test_torch_threefry.py``).

The draws are plain torch (in the JAX package they are XLA ops, not Pallas
kernels) and run on their key's device: :func:`prng_key` makes its key on
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# flat elements hashed per chunk of a draw (per key of a batch, at most)
CHUNK = 1 << 22

Shape = Union[int, Sequence[int]]
IntLike = Union[int, torch.Tensor]

# XLA's float32 ErfInv (Giles, "Approximating the erfinv function"), highest
# degree first: w = -log1p(-x²) < 5 evaluates in w - 2.5, else in √w - 3
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
F32_TINY = torch.finfo(torch.float32).tiny
# nextafter(-1, 0) in float32: the low end of normal()'s uniform
NORMAL_LO = -0.99999994


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: IntLike, k2: IntLike, x1: IntLike, x2: IntLike) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds, the hash of ``jax.random``: key words
    ``(k1, k2)`` and count words ``(x1, x2)``, uint32 values in int64
    tensors (or Python ints) that broadcast. Returns the two output words."""
    like = next((t for t in (k1, k2, x1, x2) if isinstance(t, torch.Tensor)), None)
    dev = like.device if like is not None else torch.device("cpu")
    # torch.full fills on the device: no host-to-device copy, which would
    # wait for the card's queue
    k1, k2, x1, x2 = (t if isinstance(t, torch.Tensor) else torch.full((), int(t) & MASK, dtype=torch.int64, device=dev)
                      for t in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: int, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as jax computes it without 64-bit
    types: ``[0, seed mod 2³²]`` (so ``-1`` gives ``[0, 2³² − 1]``), on
    ``device`` (``None``: the card, raising without one)."""
    key = torch.zeros(2, dtype=torch.int64, device=resolve_device(device))
    key[1:].fill_(int(seed) & MASK)  # a scalar fill on the device (``key[1] = v`` copies from the host)
    return key


def indices(item_index: Sequence[int], device: Union[str, torch.device]) -> torch.Tensor:
    """``item_index`` as an int64 tensor on ``device``; a ``range`` is made
    there (``arange``), without a host-to-device copy."""
    if isinstance(item_index, range):
        return torch.arange(item_index.start, item_index.stop, item_index.step, dtype=torch.int64, device=device)
    return torch.as_tensor(list(item_index), dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``; ``data`` is cast to uint32. A
    tensor ``data`` broadcasts against the key's batch shape: ``fold_in(key,
    idx)`` of a ``[2]`` key and ``[B]`` indices is the ``[B, 2]`` keys of
    ``vmap(lambda i: fold_in(key, i))(idx)``."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=key.device, dtype=torch.int64) & MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[..., num, 2]`` keys, key ``i`` =
    ``fold_in(key, i)``; over a batch of keys ``[..., 2]`` it is the
    ``vmap`` of split."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, idx)
    return torch.stack((b1, b2), dim=-1)


def flat_bits(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The random bits of flat elements ``idx`` (int64, on the key's
    device) of every key of ``key [..., 2]``: ``[prod(...), len(idx)]``."""
    keys = key.reshape(-1, 2)
    b1, b2 = threefry2x32(keys[:, 0:1], keys[:, 1:2], idx >> 32, idx & MASK)
    return b1 ^ b2


def _draw(key: torch.Tensor, shape: Shape, convert: Callable[[torch.Tensor], torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """``convert`` of the random bits of every key of ``key [..., 2]`` over
    ``shape``: ``[..., *shape]``, hashed ``CHUNK`` flat elements at a time."""
    shape = _shape(shape)
    n = math.prod(shape)
    nb = math.prod(key.shape[:-1])
    out = torch.empty((nb, n), dtype=dtype, device=key.device)
    step = max(1, CHUNK // max(nb, 1))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        out[:, lo:hi] = convert(flat_bits(key, torch.arange(lo, hi, dtype=torch.int64, device=key.device)))
    return out.reshape((*key.shape[:-1], *shape))


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values in [0, 2³²)."""
    return _draw(key, shape, lambda b: b, torch.int64)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) floats: the top 23 bits as the mantissa of [1, 2), − 1."""
    return (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)) - 1.0


def uniform_from_bits(bits: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Uniform floats on ``[lo, hi)`` from random bits, as ``uniform``."""
    lo_t = torch.full((), lo, dtype=torch.float32, device=bits.device)
    span = torch.full((), hi, dtype=torch.float32, device=bits.device) - lo_t
    # fused u·span + lo, as XLA contracts it (bitwise equal only so)
    return torch.maximum(lo_t, torch.addcmul(lo_t, _unit(bits), span))


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _draw(key, shape, lambda b: uniform_from_bits(b, minval, maxval), torch.float32)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv``: Giles' polynomial in ``w − 2.5`` (``w =
    −log1p(−x²) < 5``) or ``√w − 3``, times ``x``; ``±1 ↦ ±inf``. Its
    ``log1p`` is torch's, which rounds differently from XLA's in the last
    place for some inputs."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    t = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        # fused c + p·t, as XLA contracts its Horner steps: a separate product
        # and sum differ from jax in 5% of draws, the fused form in 1%
        p = torch.addcmul(torch.where(small, c_lt, c_ge), p, t)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Standard normals from random bits, as ``normal``."""
    return erf_inv(uniform_from_bits(bits, NORMAL_LO, 1.0)) * math.sqrt(2.0)


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``√2·erf_inv(u)``, ``u``
    uniform on ``[nextafter(−1, 0), 1)``."""
    return _draw(key, shape, normal_from_bits, torch.float32)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from random bits, as ``gumbel``."""
    return -torch.log(-torch.log(uniform_from_bits(bits, F32_TINY, 1.0)))


def gumbel(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode ``"low"``):
    ``−log(−log(u))``, ``u`` uniform on ``[tiny, 1)``."""
    return _draw(key, shape, gumbel_from_bits, torch.float32)


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)`` for float32 logits:
    ``argmax(logits + gumbel(key, logits.shape))`` along ``axis``."""
    return torch.argmax(logits + gumbel(key, logits.shape), dim=axis)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 without
    64-bit types) as int64: two 32-bit draws ``hi``, ``lo`` from
    ``split(key)`` folded into ``[minval, maxval)`` as jax folds them,
    ``(hi·m + lo) mod span`` in uint32 with ``m = (2¹⁶ mod span)² mod span``."""
    if not -2**31 <= minval < maxval <= 2**31 - 1:
        raise ValueError(f"randint needs int32 bounds with minval < maxval; got [{minval}, {maxval})")
    span = maxval - minval
    k = split(key)
    hi, lo = random_bits(k[..., 0, :], shape), random_bits(k[..., 1, :], shape)
    # jax's uint32 products and sums wrap (for span > 2¹⁶ the multiplier is 0)
    mult = ((2**16 % span) ** 2 & MASK) % span
    return minval + ((((hi % span) * mult & MASK) + lo % span) & MASK) % span
