from repro_torch.kernels.ff_attention.ops import (BLOCK_KV, BLOCK_Q,
                                                 attention, attention_proj,
                                                 attention_proj_ref,
                                                 attention_ref, max_depth)

__all__ = ["BLOCK_KV", "BLOCK_Q", "attention", "attention_proj",
           "attention_proj_ref", "attention_ref", "max_depth"]
