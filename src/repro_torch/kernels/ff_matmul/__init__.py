from repro_torch.kernels.ff_matmul.ops import (dispatch_matmul,
                                               dispatch_matmul_ref, matmul,
                                               matmul_ref)

__all__ = ["dispatch_matmul", "dispatch_matmul_ref", "matmul", "matmul_ref"]
