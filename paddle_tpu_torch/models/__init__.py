from .convert import from_jax_state_dict
from .generation import GenerationMixin, PagedKVCache, kv_pool_blocks
from .llama import LlamaConfig, LlamaForCausalLM
from .serving import ContinuousBatchingEngine, PrefixCache, QueueFull, Request
from .speculative import NGramProposer

__all__ = ["ContinuousBatchingEngine", "GenerationMixin", "LlamaConfig",
           "LlamaForCausalLM", "NGramProposer", "PagedKVCache", "PrefixCache",
           "QueueFull", "Request", "from_jax_state_dict", "kv_pool_blocks"]
