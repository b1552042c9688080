"""Model definitions: layer primitives, the Sana DiT and the DC-AE decoder."""
