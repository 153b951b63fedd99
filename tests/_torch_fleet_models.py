"""Model factories for the port's subprocess fleet workers
(``"_torch_fleet_models:<name>"``): a worker process imports this module
and builds its replica's model from a fixed seed, so every process holds
the same weights as the test's own in-process model."""

import torch

from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=160,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)


def build_tiny(device="cpu"):
    return LlamaForCausalLM(LlamaConfig(**CFG), device=device,
                            generator=torch.Generator().manual_seed(0))


def build_on_cuda():
    """The same model on the card: raises where there is none."""
    return build_tiny("cuda")
