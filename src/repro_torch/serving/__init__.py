"""Serving: generation loop and continuous batching."""
