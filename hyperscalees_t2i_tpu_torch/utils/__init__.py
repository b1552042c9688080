"""Small stateless helpers (seeding, the jax.random stream, tree casts)."""
