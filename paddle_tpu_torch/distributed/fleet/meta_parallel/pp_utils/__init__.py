"""Pipeline utilities: the p2p transfers between stage ranks."""

from .p2p_communication import SendRecv

__all__ = ["SendRecv"]
