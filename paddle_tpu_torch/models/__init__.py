"""Models of the port: the families the JAX package's ``models`` exports,
with its pipelined ``*Pipe`` variants (``LlamaForCausalLMPipe``,
``Qwen2MoeForCausalLMPipe``: ``fleet.meta_parallel.PipelineLayer``s)."""

from .deepseek import DeepseekV2Config, DeepseekV2ForCausalLM
from .ernie import (ErnieConfig, ErnieForMaskedLM, ErnieForPretraining,
                    ErnieForSequenceClassification, ErnieModel)
from .gpt2 import GPT2Config, GPT2ForCausalLM, GPT2Model
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaForCausalLMPipe,
                    LlamaModel, LlamaPretrainingCriterion)
from .qwen2 import (Qwen2Config, Qwen2ForCausalLM, Qwen2MoeConfig,
                    Qwen2MoeForCausalLM, Qwen2MoeForCausalLMPipe,
                    Qwen2MoePretrainingCriterion)

__all__ = ["GPT2Config", "GPT2Model", "GPT2ForCausalLM", "LlamaConfig",
           "LlamaForCausalLM", "LlamaModel", "LlamaPretrainingCriterion",
           "LlamaForCausalLMPipe", "Qwen2Config", "Qwen2ForCausalLM",
           "Qwen2MoeConfig", "Qwen2MoeForCausalLM",
           "Qwen2MoeForCausalLMPipe", "Qwen2MoePretrainingCriterion",
           "ErnieConfig", "ErnieModel", "ErnieForPretraining",
           "ErnieForMaskedLM", "ErnieForSequenceClassification",
           "DeepseekV2Config", "DeepseekV2ForCausalLM"]
