"""Synthetic data — the port's copy of ``repro.data``."""

from .synthetic import BatchIterator, synthetic_session, token_stream

__all__ = ["BatchIterator", "synthetic_session", "token_stream"]
