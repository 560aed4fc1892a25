"""``incubate.distributed`` of the port: the MoE models."""

from . import models

__all__ = ["models"]
