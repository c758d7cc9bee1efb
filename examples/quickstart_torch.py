"""Quickstart of the PyTorch/H100 port: the feed-forward pipe stack.

1. Plan a pipe for a workload on the port's card model (H100_SXM).
2. Run a kernel against its plain version through the public
   ``repro_torch.ops`` / ``repro_torch.policy`` API.
3. Run the registered MoE graph: the dispatch gather feeding the expert
   matmul in ONE launch, against its staged composition.
4. Build an assigned architecture, run a train step and a prefill.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(default: the kernels on the CUDA card; ``--device cpu`` runs their plain
versions.)
"""

import argparse

import torch

import repro_torch
from repro_torch.core.pipeline_model import (H100_SXM, Workload,
                                             estimate_baseline,
                                             estimate_feedforward)
from repro_torch.core.planner import plan_pipe


def pipe_planning():
    print("== 1. pipe planning (paper §3, automated) ==")
    w = Workload(n_words=4096, word_bytes=128 * 128 * 4,
                 flops_per_word=2 * 128 * 128 * 128, regular=True)
    plan = plan_pipe(w, tile=(128, 128), dtype=torch.float32, hw=H100_SXM)
    base = estimate_baseline(w, H100_SXM)
    ff = estimate_feedforward(w, H100_SXM, plan.pipe)
    print(f" plan: depth={plan.pipe.depth} streams={plan.pipe.streams} "
          f"smem={plan.pipe.smem_bytes >> 10} KiB")
    print(f" modeled: baseline {base.total_s * 1e3:.2f} ms -> "
          f"ff {ff.total_s * 1e3:.2f} ms ({base.total_s / ff.total_s:.1f}x); "
          f"{plan.rationale}")


def kernel_demo(dev):
    print("== 2. DAE kernel vs its plain version ==")
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((256, 256), generator=gen, device=dev)
    b = torch.randn((256, 256), generator=gen, device=dev)
    # the plain version is a policy mode too: no kernel-module imports
    with repro_torch.policy(mode="ref"):
        ref = repro_torch.ops.matmul(a, b)
    # explicit per-call policy (the paper's programmer-chosen sizing)
    out = repro_torch.ops.matmul(
        a, b, policy=repro_torch.PipePolicy(depth=3, streams=2))
    print(f" ops.matmul(depth=3, streams=2) max|err| = "
          f"{float((out - ref).abs().max()):.2e}")
    # session defaults: planner-sized ff vs the synchronous baseline
    with repro_torch.policy(mode="baseline"):
        base = repro_torch.ops.matmul(a, b)
    print(f" baseline (depth=1 via repro_torch.policy) max|err| = "
          f"{float((base - ref).abs().max()):.2e}")


def graph_demo(dev):
    print("== 3. fused graph: MoE dispatch -> expert matmul ==")
    from repro_torch.kernels.registry import get_graph, run_graph_smoke

    # the registered MoE graph: an irregular gather (dispatch) feeding a
    # regular matmul (expert FFN). compile_graph fuses dispatch->expert
    # onto one launch (ff_matmul's dispatch path: the dispatched rows are
    # read through the index and never written) and stages
    # expert->combine (a gather edge cannot fuse: its addresses are
    # data-dependent)
    spec = get_graph("moe_dispatch_ffn")
    out, ref, err, compiled = run_graph_smoke(spec, device=dev)
    print(f" units: {[(u.kind, u.out_node, u.launch) for u in compiled.units]}")
    for ep in compiled.plan.edges:
        print(f" edge {ep.edge.label}: {ep.mode}"
              + (f" (saves {ep.hbm_bytes_saved / 1024:.0f} KiB of device "
                 f"memory traffic)" if ep.mode == "fused" else ""))
    est = compiled.plan.estimate
    report = compiled.report
    print(f" modeled: unfused {est.unfused_s * 1e6:.1f} us -> graph "
          f"{est.total_s * 1e6:.1f} us ({est.overlap_speedup:.2f}x)")
    print(f" fused == staged composition bit for bit: "
          f"{report['fused_equals_staged']}; max|err| vs plain = {err:.2e} "
          f"(staged {report['staged_err']:.2e})")


def model_demo(dev):
    print("== 4. assigned architecture: train + serve ==")
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import build_model
    from repro_torch.optim import adamw

    cfg = smoke_config("llama3_2_1b")
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, dev)
    print(f" llama3.2-style smoke model: {model.param_count():,} params")

    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen, device=dev)
    labels = torch.randint(0, cfg.vocab, (2, 32), generator=gen, device=dev)
    logits, _ = model.prefill(params, {"tokens": tokens})
    tok = torch.argmax(logits, dim=-1)
    print(f" prefill -> first sampled tokens: {tok.tolist()}")

    # training runs the plain ("xla") attention, as the reference's trainer
    train_model = build_model(cfg.replace(attn_impl="xla", scan_impl="xla"))
    train_step = steps_lib.make_train_step(train_model)
    _, _, metrics = train_step(params, adamw.init(params),
                               {"tokens": tokens, "labels": labels})
    print(f" one train step: loss={float(metrics['loss']):.4f} "
          f"gnorm={float(metrics['grad_norm']):.3f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    pipe_planning()
    kernel_demo(dev)
    graph_demo(dev)
    model_demo(dev)
    print("quickstart done")
