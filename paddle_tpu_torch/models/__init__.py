"""Models of the port."""

from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel"]
