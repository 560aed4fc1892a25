"""Serving of the port: the continuous-batching engine, its reliability
layer, the fault-tolerant fleet and the OpenAI-compatible HTTP front
door."""

from .api_server import ApiServer
from .fleet import FleetReplica, ServingFleet
from .reliability import (AdmissionController, DeadlineExceeded,
                          EngineSupervisor, Overloaded, ReplicaFailed,
                          RequestCancelled, RequestQuarantined,
                          ServingError)
from .serving import ContinuousBatchingEngine, ServedRequest
from .spec_decode import (DraftSource, NGramDraftSource,
                          SelfSpecDraftSource, get_draft_source)

__all__ = ["AdmissionController", "ApiServer", "ContinuousBatchingEngine",
           "DeadlineExceeded", "DraftSource", "EngineSupervisor",
           "FleetReplica", "NGramDraftSource", "Overloaded",
           "ReplicaFailed", "RequestCancelled", "RequestQuarantined",
           "SelfSpecDraftSource", "ServedRequest", "ServingError",
           "ServingFleet", "get_draft_source"]
