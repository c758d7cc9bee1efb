"""Microbenchmark sweep of the PyTorch/H100 port: explore the feed-forward
design space (depth x streams x access pattern x divergence) with the
analytic model, the way the paper's §4.2 sweeps channel depths and
producer counts, on the paper's board and on the port's card model
(H100_SXM: modeled times, not measured ones); then check the matching
kernel against its plain version.

Run:  PYTHONPATH=src python examples/microbench_sweep_torch.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core.pipe import Pipe
from repro_torch.core.pipeline_model import (ARRIA_CX, H100_SXM, Workload,
                                             estimate_baseline,
                                             estimate_feedforward)


def sweep(hw, name):
    print(f"== {name}: FF speedup over baseline (depth x streams) ==")
    for regular in (True, False):
        for div in (0.0, 0.8):
            w = Workload(n_words=1 << 20, word_bytes=128,
                         flops_per_word=256, regular=regular,
                         divergence=div, dlcd_cycles=8,
                         false_mlcd_ii=120.0)
            base = estimate_baseline(w, hw)
            cells = []
            for depth in (2, 4, 8, 16):
                for streams in (1, 2, 4):
                    ff = estimate_feedforward(
                        w, hw, Pipe(tile=(8, 128), depth=depth,
                                    streams=streams))
                    cells.append((depth, streams, base.total_s / ff.total_s))
            best = max(cells, key=lambda c: c[2])
            row = " ".join(f"d{d}s{s}={x:5.2f}x" for d, s, x in cells[:6])
            print(f" {'reg' if regular else 'irr'} div={div:.1f}: {row} ...")
            print(f"   best: depth={best[0]} streams={best[1]} "
                  f"-> {best[2]:.2f}x")


def kernel_check(dev):
    print("== the scan kernel vs its plain versions ==")
    import repro_torch
    from repro_torch.kernels.ff_chunk_scan.ref import chunk_scan_xla
    gen = torch.Generator(device=dev).manual_seed(0)
    q = 0.5 * torch.randn((2, 128, 32), generator=gen, device=dev)
    kk = 0.5 * torch.randn((2, 128, 32), generator=gen, device=dev)
    v = torch.randn((2, 128, 64), generator=gen, device=dev)
    lw = -torch.exp(torch.randn((2, 128, 32), generator=gen, device=dev))
    with repro_torch.policy(mode="ref"):
        ref = repro_torch.ops.chunk_scan(q, kk, v, lw)
    # "xla": the reference's chunked XLA formulation, plain PyTorch here
    out = chunk_scan_xla(q, kk, v, lw)
    print(f" chunk_scan[xla] max|err| = "
          f"{float((out - ref).abs().max()):.2e}")
    with repro_torch.policy(mode="ff"):
        out = repro_torch.ops.chunk_scan(q, kk, v, lw)
    print(f" chunk_scan[ff] max|err| = {float((out - ref).abs().max()):.2e}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    sweep(ARRIA_CX, "paper board (Arria CX)")
    sweep(H100_SXM, "target (H100 SXM, modeled)")
    kernel_check(dev)
