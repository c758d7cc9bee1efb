from repro_torch.kernels.ff_layer.ops import (ff_layer_matmul,
                                              ff_layer_matmul_ref,
                                              ff_layer_mlp_tail,
                                              ff_layer_mlp_tail_ref,
                                              ff_layer_swiglu,
                                              ff_layer_swiglu_ref,
                                              mlp_tail_staged)

__all__ = ["ff_layer_matmul", "ff_layer_matmul_ref", "ff_layer_mlp_tail",
           "ff_layer_mlp_tail_ref", "ff_layer_swiglu", "ff_layer_swiglu_ref",
           "mlp_tail_staged"]
