"""Generator backends (Sana one-step so far)."""
