"""Process-local utilities (metrics)."""
