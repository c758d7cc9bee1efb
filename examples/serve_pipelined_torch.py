"""Batched serving example of the PyTorch/H100 port: continuous-batching
greedy decode with separate prefill/decode steps (the feed-forward model
at the serving level: prefill produces the KV-cache pipe, the decode loop
consumes it), through the ``repro_torch.ops`` kernels under a session
policy.

The serving driver installs the session :class:`repro_torch.PipePolicy`
around the prefill/decode step bodies, so every attention call inside the
model resolves its pipe plan. This example shows the same two-layer API
directly first (``repro_torch.ops`` + ``with repro_torch.policy(...)``),
then runs the full driver.

Run:  PYTHONPATH=src python examples/serve_pipelined_torch.py [--device cpu]
"""

import argparse

import torch

import repro_torch
from repro_torch.launch import serve as serve_mod


def decode_attention_demo(dev):
    """One serving decode step through repro_torch.ops: the KV cache is the
    pipe, flash-decode is the consumer. Policies come from the session
    context: no per-op mode/depth/streams keywords anywhere."""
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, d, s_kv = 2, 4, 64, 128
    q = torch.randn((b, h, d), generator=gen, device=dev)
    k = torch.randn((b, h, s_kv, d), generator=gen, device=dev)
    v = torch.randn((b, h, s_kv, d), generator=gen, device=dev)
    lengths = torch.tensor([70, 128], dtype=torch.int32, device=dev)

    with repro_torch.policy(mode="ref"):           # the plain version
        ref = repro_torch.ops.decode_attention(q, k, v, lengths, block_kv=64)
    with repro_torch.policy(mode="ff"):            # planner-sized pipes
        out = repro_torch.ops.decode_attention(q, k, v, lengths, block_kv=64)
    err = float((out - ref).abs().max())
    print(f"decode_attention via repro_torch.ops: max|err| vs plain = "
          f"{err:.2e}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args().device
    decode_attention_demo(torch.device(device))
    # the full continuous-batching driver: --impl ff routes the model's
    # attention call sites through the same repro_torch.ops kernels, with
    # the session policy installed around the step bodies
    with repro_torch.policy(mode="ff"):
        serve_mod.main(["--arch", "qwen1_5_0p5b", "--smoke", "--impl", "ff",
                        "--policy-mode", "ff", "--requests", "4",
                        "--prompt-len", "16", "--max-new", "8",
                        "--device", device])
