"""Serve internals: the data-plane instruments and the admission gate."""
