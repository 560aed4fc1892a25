"""``incubate.distributed.models.moe`` of the port: the MoE layer and its
gate specs."""

from .moe_layer import GShardGate, MoELayer, SwitchGate

__all__ = ["MoELayer", "GShardGate", "SwitchGate"]
