"""Test support of the port: deterministic fault injection and draft
sources with known acceptance."""

from .drafts import OracleDraftSource
from .fault_injection import FaultInjector, FaultPlan

__all__ = ["FaultInjector", "FaultPlan", "OracleDraftSource"]
