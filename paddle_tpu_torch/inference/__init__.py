"""Serving of the port."""

from .serving import ContinuousBatchingEngine, ServedRequest

__all__ = ["ContinuousBatchingEngine", "ServedRequest"]
