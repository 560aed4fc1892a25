"""Models of the port."""

from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaPretrainingCriterion)
from .qwen2 import (Qwen2Config, Qwen2ForCausalLM, Qwen2MoeConfig,
                    Qwen2MoeForCausalLM, Qwen2MoePretrainingCriterion)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaPretrainingCriterion", "Qwen2Config", "Qwen2ForCausalLM",
           "Qwen2MoeConfig", "Qwen2MoeForCausalLM",
           "Qwen2MoePretrainingCriterion"]
