"""In-step ES health diagnostics."""
