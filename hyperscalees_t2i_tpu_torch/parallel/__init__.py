"""Lane-batched generation over adapter batches."""
