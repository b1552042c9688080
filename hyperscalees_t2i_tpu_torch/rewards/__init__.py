"""CLIP/PickScore rewards over image batches."""
