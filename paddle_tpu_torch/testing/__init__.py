"""Test support of the port: deterministic fault injection."""

from .fault_injection import FaultInjector, FaultPlan

__all__ = ["FaultInjector", "FaultPlan"]
