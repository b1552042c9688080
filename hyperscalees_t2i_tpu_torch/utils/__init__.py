"""Small stateless helpers (seeding, tree casts)."""
