"""Top-k / top-p filtered categorical sampling with given Gumbel noise.

Port of ``hyperscalees_t2i_tpu/ops/sampling.py``. The JAX package draws
with ``jax.random.categorical(key, logits)``, which is
``argmax(logits + gumbel(key, logits.shape))``; here the Gumbel noise is an
argument, drawn ahead by :func:`per_scale_gumbel` from the same keys, so the
same filtered logits give the same ids (up to ``log`` rounding of the
noise, ``utils.threefry``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..utils import threefry

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


def per_scale_gumbel(key: torch.Tensor, item_index: Sequence[int], patch_nums: Sequence[int],
                     tail: Tuple[int, ...]) -> torch.Tensor:
    """``[..., len(item_index), L, *tail]`` standard Gumbel noise on the
    key's device, ``L = Σ pn²``: image ``i``'s rows of scale ``si`` are
    ``gumbel(fold_in(fold_in(key, si), item_index[i]), (pn², *tail))``, the
    noise of the JAX package's per-scale ``jax.random.categorical`` keys
    (VAR: ``tail = (V,)``; Infinity: ``(bits, 2)``). A batch of keys
    ``[..., 2]`` draws each key's images."""
    idx = threefry.indices(item_index, key.device)
    parts = [threefry.gumbel(threefry.fold_in(threefry.fold_in(key, si)[..., None, :], idx), (pn * pn, *tail))
             for si, pn in enumerate(patch_nums)]
    return torch.cat(parts, dim=-1 - len(tail))
