"""Serving of the port."""

from .reliability import (AdmissionController, DeadlineExceeded,
                          EngineSupervisor, Overloaded, RequestCancelled,
                          RequestQuarantined, ServingError)
from .serving import ContinuousBatchingEngine, ServedRequest
from .spec_decode import (DraftSource, NGramDraftSource,
                          SelfSpecDraftSource, get_draft_source)

__all__ = ["AdmissionController", "ContinuousBatchingEngine",
           "DeadlineExceeded", "DraftSource", "EngineSupervisor",
           "NGramDraftSource", "Overloaded", "RequestCancelled",
           "RequestQuarantined", "SelfSpecDraftSource", "ServedRequest",
           "ServingError", "get_draft_source"]
