"""The ES training step."""
