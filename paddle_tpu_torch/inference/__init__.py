"""Serving of the port: the continuous-batching engine, its reliability
layer, the fault-tolerant fleet, process-backed replicas and their wire
protocol, disaggregated prefill/decode, the SLO-driven autoscaler and
the OpenAI-compatible HTTP front door.

Names and submodules load at first use, so a replica worker process
(``python -m paddle_tpu_torch.inference.worker``) starts its heartbeat
before torch is imported."""

import importlib

_LAZY = {
    "ApiServer": ".api_server",
    "FleetAutoscaler": ".autoscaler",
    "DisaggServingFleet": ".disagg",
    "FleetReplica": ".fleet", "ServingFleet": ".fleet",
    "ProcReplica": ".proc_replica",
    "AdmissionController": ".reliability",
    "DeadlineExceeded": ".reliability",
    "EngineSupervisor": ".reliability", "Overloaded": ".reliability",
    "ReplicaFailed": ".reliability", "RequestCancelled": ".reliability",
    "RequestQuarantined": ".reliability", "ServingError": ".reliability",
    "ContinuousBatchingEngine": ".serving", "ServedRequest": ".serving",
    "DraftSource": ".spec_decode", "NGramDraftSource": ".spec_decode",
    "SelfSpecDraftSource": ".spec_decode",
    "get_draft_source": ".spec_decode",
    "FrameCorrupt": ".wire", "FrameOutOfOrder": ".wire",
    "FrameTooLarge": ".wire", "WireClosed": ".wire", "WireError": ".wire",
    "WireTimeout": ".wire",
}

_SUBMODULES = ("api_server", "autoscaler", "disagg", "fleet",
               "proc_replica", "reliability", "serving", "spec_decode",
               "wire", "worker")

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY) | set(_SUBMODULES))
