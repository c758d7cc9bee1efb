from repro_torch.kernels.ff_chunk_scan.ops import (chunk_scan,
                                                   chunk_scan_plain,
                                                   chunk_scan_ref,
                                                   f32_max_depth,
                                                   f32_ring_smem_bytes,
                                                   max_depth,
                                                   ring_smem_bytes)

__all__ = ["chunk_scan", "chunk_scan_plain", "chunk_scan_ref",
           "f32_max_depth", "f32_ring_smem_bytes", "max_depth",
           "ring_smem_bytes"]
