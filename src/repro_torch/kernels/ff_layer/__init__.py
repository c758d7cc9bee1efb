from repro_torch.kernels.ff_layer.ops import (ff_layer_matmul,
                                              ff_layer_matmul_ref,
                                              ff_layer_mlp_tail,
                                              ff_layer_mlp_tail_ref,
                                              ff_layer_swiglu,
                                              ff_layer_swiglu_ref,
                                              mlp_tail_staged)
from repro_torch.kernels.ff_layer.program import (build_matmul_program,
                                                  build_swiglu_program)

__all__ = ["build_matmul_program", "build_swiglu_program",
           "ff_layer_matmul", "ff_layer_matmul_ref", "ff_layer_mlp_tail",
           "ff_layer_mlp_tail_ref", "ff_layer_swiglu", "ff_layer_swiglu_ref",
           "mlp_tail_staged"]
