"""Models of the port: the families the JAX package's ``models`` exports
(its ``*Pipe`` pipeline variants go with ROADMAP A.7)."""

from .deepseek import DeepseekV2Config, DeepseekV2ForCausalLM
from .ernie import (ErnieConfig, ErnieForMaskedLM, ErnieForPretraining,
                    ErnieForSequenceClassification, ErnieModel)
from .gpt2 import GPT2Config, GPT2ForCausalLM, GPT2Model
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaPretrainingCriterion)
from .qwen2 import (Qwen2Config, Qwen2ForCausalLM, Qwen2MoeConfig,
                    Qwen2MoeForCausalLM, Qwen2MoePretrainingCriterion)

__all__ = ["GPT2Config", "GPT2Model", "GPT2ForCausalLM", "LlamaConfig",
           "LlamaForCausalLM", "LlamaModel", "LlamaPretrainingCriterion",
           "Qwen2Config", "Qwen2ForCausalLM", "Qwen2MoeConfig",
           "Qwen2MoeForCausalLM", "Qwen2MoePretrainingCriterion",
           "ErnieConfig", "ErnieModel", "ErnieForPretraining",
           "ErnieForMaskedLM", "ErnieForSequenceClassification",
           "DeepseekV2Config", "DeepseekV2ForCausalLM"]
