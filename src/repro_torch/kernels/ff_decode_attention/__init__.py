from repro_torch.kernels.ff_decode_attention.ops import (decode_attention,
                                                        decode_attention_ref)

__all__ = ["decode_attention", "decode_attention_ref"]
