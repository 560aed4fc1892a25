"""Models of the port."""

from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaPretrainingCriterion)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaPretrainingCriterion"]
