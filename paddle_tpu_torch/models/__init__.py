from .convert import (from_jax_state_dict, named_grads,
                      named_optimizer_state)
from .generation import GenerationMixin, PagedKVCache, kv_pool_blocks
from .llama import LlamaConfig, LlamaForCausalLM, LlamaPretrainingCriterion
from .serving import ContinuousBatchingEngine, PrefixCache, QueueFull, Request
from .speculative import NGramProposer

__all__ = ["ContinuousBatchingEngine", "GenerationMixin", "LlamaConfig",
           "LlamaForCausalLM", "LlamaPretrainingCriterion", "NGramProposer",
           "PagedKVCache", "PrefixCache", "QueueFull", "Request",
           "from_jax_state_dict", "kv_pool_blocks", "named_grads",
           "named_optimizer_state"]
