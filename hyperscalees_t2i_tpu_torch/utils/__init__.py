"""Small stateless helpers (seeding, the jax.random stream, tree casts).

The flat-vector helpers of ``pytree`` are re-exported lazily (PEP 562, as
the JAX package's ``utils/__init__.py`` does): ``pytree`` imports torch,
and ``utils.stats`` and ``utils.jsonl`` serve the torch-free ``obs`` layer
and the runner's parent, which must not import it."""

_PYTREE = ("tree_size", "tree_to_flat", "flat_to_tree", "tree_norms")

__all__ = list(_PYTREE)


def __getattr__(name):
    if name in _PYTREE:
        from . import pytree

        return getattr(pytree, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
