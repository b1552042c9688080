"""Top-k / top-p filtered categorical sampling with given Gumbel noise.

Port of ``hyperscalees_t2i_tpu/ops/sampling.py``. The JAX package draws
with ``jax.random.categorical(key, logits)``, which is
``argmax(logits + gumbel(key, logits.shape))``; here the Gumbel noise is an
argument (the backends draw it, and the tests hand in ``jax.random``'s), so
the same filtered logits and the same noise give the same ids.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..utils.seeding import item_seed

NEG_INF = -1e30


def filter_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep every logit not below the k-th largest of its row; the rest →
    ``NEG_INF``. ``k <= 0`` or ``k >= V`` keeps all."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device), logits)


def filter_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: on the descending sort, keep token i while the f32
    probability mass of the tokens before it is below ``p``; every logit
    below the smallest kept one → ``NEG_INF``. ``p <= 0`` or ``p >= 1``
    keeps all."""
    if p <= 0.0 or p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.to(torch.float32), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    kth = ((cum - probs) < p).sum(dim=-1, keepdim=True) - 1
    thresh = torch.gather(sorted_logits, -1, kth)
    return torch.where(logits < thresh, torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device), logits)


def sample_top_k_top_p(logits: torch.Tensor, gumbel: torch.Tensor, top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """Filtered categorical sample over the last axis → int64 ids:
    ``argmax(filter_top_p(filter_top_k(logits)) + gumbel)`` in f32."""
    lg = filter_top_p(filter_top_k(logits.to(torch.float32), top_k), top_p)
    return torch.argmax(lg + gumbel.to(torch.float32), dim=-1)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel ``-log(-log U)`` from uniforms in [0, 1), with U
    clamped below at the smallest normal f32, as ``jax.random.gumbel``
    draws it."""
    u = u.to(torch.float32).clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def per_image_gumbel(seed: int, item_index: Sequence[int], shape: Tuple[int, ...],
                     device: torch.device) -> torch.Tensor:
    """``[len(item_index), *shape]`` standard Gumbel draws; image ``i`` from a
    CPU generator seeded by ``(seed, item_index[i])`` only."""
    out = []
    for idx in item_index:
        g = torch.Generator(device="cpu").manual_seed(item_seed(seed, int(idx)))
        out.append(gumbel_from_uniform(torch.rand(shape, generator=g)))
    return torch.stack(out).to(device)
