from .bert import (BertConfig, BertForQuestionAnswering,
                   BertForSequenceClassification, BertModel)
from .convert import (from_jax_optimizer_state, from_jax_state_dict,
                      named_grads, named_optimizer_state)
from .generation import (GenerationMixin, KVCache, PagedKVCache,
                         kv_pool_blocks)
from .llama import LlamaConfig, LlamaForCausalLM, LlamaPretrainingCriterion
from .ocr import CRNN, CTCHeadLoss, DBLoss, DBNet
from .moe import (MoEConfig, MoEDecoderLayer, MoEForCausalLM, MoEMLP,
                  MoEModel, MoEPretrainingCriterion)
from .serving import (ContinuousBatchingEngine, GangScheduledEngine,
                      PrefixCache, QueueFull, Request)
from .speculative import NGramProposer

__all__ = ["BertConfig", "BertForQuestionAnswering",
           "BertForSequenceClassification", "BertModel", "CRNN",
           "CTCHeadLoss", "ContinuousBatchingEngine", "DBLoss", "DBNet",
           "GangScheduledEngine", "GenerationMixin", "KVCache",
           "LlamaConfig",
           "LlamaForCausalLM", "LlamaPretrainingCriterion", "MoEConfig",
           "MoEDecoderLayer", "MoEForCausalLM", "MoEMLP", "MoEModel",
           "MoEPretrainingCriterion", "NGramProposer",
           "PagedKVCache", "PrefixCache", "QueueFull", "Request",
           "from_jax_optimizer_state", "from_jax_state_dict",
           "kv_pool_blocks", "named_grads",
           "named_optimizer_state"]
