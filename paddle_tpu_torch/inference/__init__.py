"""Serving of the port."""

from .reliability import (AdmissionController, DeadlineExceeded,
                          EngineSupervisor, Overloaded, RequestCancelled,
                          RequestQuarantined, ServingError)
from .serving import ContinuousBatchingEngine, ServedRequest

__all__ = ["AdmissionController", "ContinuousBatchingEngine",
           "DeadlineExceeded", "EngineSupervisor", "Overloaded",
           "RequestCancelled", "RequestQuarantined", "ServedRequest",
           "ServingError"]
