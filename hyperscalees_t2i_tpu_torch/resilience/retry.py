"""Bounded exponential-backoff retry for host-side I/O (port of
``hyperscalees_t2i_tpu/resilience/retry.py`` without its fault-injection
hooks and its multi-host jitter).

``OSError`` is retried, except the clearly permanent kinds (missing file,
wrong path kind). Delays are ``base · 2^i`` capped at ``max_delay_s``, with
no jitter. ``HYPERSCALEES_RETRY_ATTEMPTS`` and ``HYPERSCALEES_RETRY_BASE_S``
override the attempts and the base delay (0 makes retries sleep-free). With
a ``registry``, each retry ticks ``retries`` and ``retry/<site>``, and an
exhausted retry ``retry_exhausted``.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Callable, Dict, Optional, Tuple, Type

_DEF_ATTEMPTS = 3
_DEF_BASE_S = 0.25
_NO_RETRY: Tuple[Type[BaseException], ...] = (FileNotFoundError, IsADirectoryError, NotADirectoryError)


def _env_number(name: str, kind: type) -> Optional[Any]:
    v = os.environ.get(name, "").strip()
    try:
        return kind(v) if v else None
    except ValueError:
        return None


def call_with_retry(fn: Callable[..., Any], args: Tuple = (), kwargs: Optional[Dict[str, Any]] = None, *,
                    site: str = "io", attempts: Optional[int] = None, base_delay_s: Optional[float] = None,
                    max_delay_s: float = 8.0, registry: Optional[Any] = None) -> Any:
    """``fn(*args, **kwargs)``, retried on transient ``OSError``; the last
    exception is re-raised once the attempts are spent."""
    kwargs = kwargs or {}
    n = _env_number("HYPERSCALEES_RETRY_ATTEMPTS", int)
    n = max(1, (_DEF_ATTEMPTS if attempts is None else attempts) if n is None else n)
    base = _env_number("HYPERSCALEES_RETRY_BASE_S", float)
    if base is None:
        base = _DEF_BASE_S if base_delay_s is None else base_delay_s
    for attempt in range(1, n + 1):
        try:
            return fn(*args, **kwargs)
        except _NO_RETRY:
            raise
        except OSError as e:
            if attempt >= n:
                if registry is not None:
                    registry.inc("retry_exhausted")
                raise
            delay = min(max_delay_s, base * (2 ** (attempt - 1)))
            if registry is not None:
                registry.inc("retries")
                registry.inc(f"retry/{site}")
            print(f"[resilience] RETRY {site}: attempt {attempt}/{n} failed with {e!r}; "
                  f"retrying in {delay:.2f}s", file=sys.stderr, flush=True)
            if delay > 0:
                time.sleep(delay)


def retry(fn: Optional[Callable] = None, *, site: str = "io", attempts: Optional[int] = None,
          base_delay_s: Optional[float] = None, max_delay_s: float = 8.0) -> Callable:
    """Decorator form of :func:`call_with_retry`, bare (``@retry``) or
    configured (``@retry(site="weights")``)."""
    import functools

    def deco(f: Callable) -> Callable:
        @functools.wraps(f)
        def wrapper(*a, **k):
            return call_with_retry(f, a, k, site=site, attempts=attempts, base_delay_s=base_delay_s,
                                   max_delay_s=max_delay_s)

        return wrapper

    return deco(fn) if fn is not None else deco
