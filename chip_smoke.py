#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final result line):
  a. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, all started together);
  b. hold each kernel against its plain PyTorch version on the card at the
     serving shapes and at wider shapes (ragged edges, GQA, 64 pages, an
     inactive row, sentinel table entries; decode attention also at the
     prompt-256 and long shapes of phase f, at GQA 6 with pages of 8 and
     a length past the cache, its split shapes and zamba2's head dim 80
     bitwise across the ring's depth {1, 2, 4} x streams {1, 2}, paged
     == contiguous at each; for the decode-layer kernels
     B in {1, 13, 16}, RMSNorm off and on, both epilogues): float32 within
     2e-4 (the reference registry's tolerance), bfloat16 within 2e-2, the
     paged kernel equal to the contiguous one bit for bit at block_kv ==
     page, and the one-launch MLP tail equal to its three staged launches
     bit for bit; then a full-width decode layer on the card against its
     plain version on the CPU, and the smoke model on the card against the
     same model on the CPU (dense, paged and through the layer graph);
     then the library kernels (matmul, gather, attention -> projection,
     MoE dispatch -> expert) at full width and at ragged shapes, float32
     within 5e-4 and bfloat16 within 2e-2 (relative and absolute), the
     gather exactly (at both LIB shapes, a ragged n, a 7-element row and
     6,144 short rows also at every ring depth up to its max_depth x
     streams {1, 2}),
     and each fused launch (attention_proj, the MoE
     dispatch, the paged kernel) equal to its staged composition bit for
     bit, and the bf16 kernels on the ring (the product, the dispatch,
     attention at the 256-token serve shape, attention_proj, and at the
     serve shape the decode layer's q-projection, SwiGLU and MLP tail)
     equal across
     the ring's depth {1, 2, 4} x streams {1, 2} bit for bit (plus a
     row-strided bf16 operand pair that TMA cannot describe); then the
     gated linear-attention scan (ff_chunk_scan) at both recurrent models'
     prefill shapes (rwkv6-7b exclusive with u, zamba2 inclusive; B = 4,
     S = 256, their stream types and f32) at chunk 64 and 256, at a ragged
     S = 200 with chunk 32/64/128, at N = P = 128 with chunk 256 and on a
     strong decay (f32 and bf16), float32 within 3e-5 of max |plain| and
     bfloat16 within 2e-2, and the bf16 scan at both models' shapes equal
     across the ring's depth {1, 2, 4} x streams {1, 2}, the f32 scan (the
     f32 ring body) at both models' shapes and at N = P = 256 across depth
     {1, 2, 4, deepest} x streams {1, 2, 4}; attention and decode
     attention at zamba2's head dim 80, attention at head dim 128 (qwen2-
     72b's heads, GQA 8); the smoke rwkv6 and zamba2 models on the card
     against the CPU (prefill, 3 greedy decode steps; rwkv6 also under
     ``scan_impl="xla_tiled"``) and their f32 prefill -> decode handoff
     gap within 1e-3; the smoke qwen model also under ``--impl xla``;
     the AdamW kernel (``csrc/adamw.cu``, hand-fused: no Pallas
     counterpart) against its plain version on full-width llama3.2-1b's
     f32 leaves after one clipped update, p, m and v within 1e-5 of their
     max |plain| and grad_norm and lr within 1e-5 relative, with its time,
     the plain version's and ``torch._fused_adamw_``'s (an ``adamw``
     line);
     prefill and decode attention at grok-1's heads (48 of 128 over 8,
     GQA 6) at its serve shapes, paged == contiguous bit for bit and both
     bitwise across depth x streams; the smoke grok-1 and
     deepseek-v2-lite models on the card against the CPU (prefill, 3
     greedy decode steps, logits within MODEL_TOL) and their routing (the
     top-k experts of every token, layer and step) equal; rows 1-3 at the
     heads of llama3.2-1b (32/8 of 64, GQA 4), internvl2-1b (14/2 of 64,
     GQA 7), starcoder2-15b (48/4 of 128, GQA 12) and qwen2-72b (64/8 of
     128, GQA 8) at their serve shapes, paged == contiguous and both
     decode kernels and prefill attention (bf16) bitwise across depth x
     streams; the decode-layer kernels (rows 4-6) at llama3.2-1b's widths
     (d 2048, f 8192) and at qwen2-72b's (d 8192, f 29568: k past 8192,
     bf16 and f32), the MLP tail == its staged launches bit for bit, the
     bf16 kernels bitwise across depth x streams, and at qwen's serve
     shape the f32 ones (one ring body with bf16) bitwise across depth
     {1, 2, 4, deepest} x streams {1, 2, 4, 8}, the f32 tail == its staged
     launches at each of those settings; the chunk scan also at
     N = P = 256, chunk 256 (f32 and bf16); the smoke llama3.2-1b,
     starcoder2-15b,
     qwen2-72b, internvl2-1b (with and without patch embeddings) and
     whisper-tiny (with frames) models on the card against the CPU; the
     f32 rings of the product and of attention bit for bit across
     their depth {1, 2, 4, deepest} x streams: the f32 and f32 x bf16
     products at the LIB and ragged shapes and row-strided, the gathered
     f32 launch == gather then matmul and the f32 attention_proj ==
     attention then matmul at each setting, f32 attention at the serve,
     256-token and non-causal shapes and at head dims 80 and 128;
  c. serve full-width qwen1.5-0.5B (random weights from seed 0, cast once)
     through ``repro_torch.launch.serve.serve_bench`` with the serve
     defaults, once more with 256-token prompts, and once with
     ``--layer-graph``; then full-width grok-1 cut to 2 of its 64 layers
     (``--n-layers 2``) with the serve defaults; then full-width
     llama3.2-1b (once more with ``--layer-graph``), starcoder2-15b (all
     40 layers), qwen2-72b cut to 16 of its 80 layers (once more with
     ``--layer-graph``: its MLP tail at d_ff 29568) and internvl2-1b on
     text prompts, one model on the card at a time, each followed by its
     steps compiled against eager bit for bit: every prefill bucket and
     decode step a CUDA graph captured once per signature and replayed
     (``launch/steps.py``), required of every run;
  d. require equal token counts, and paged == dense decode bit for bit on
     the per-op runs (the layer graph rounds elsewhere in bf16: its
     difference is printed and must be finite);
  e. require each run's kernels' launch counts, taken over that run, > 0;
     then drive the library path (``repro_torch.ops.matmul`` / ``gather``,
     ``attention_proj``, ``moe_dispatch_ffn``, the staged paged decode) at
     full width with the counts set to 0 just before, require each of its
     kernels launched, and hold its outputs against the same calls on CPU
     copies of the operands (plain versions); then full-width rwkv6-7b
     and zamba2-2.7b (random f32 weights from seed 0, one model at a
     time): with the counts set to 0, one prefill of 4 x 256-token prompts
     and 16 greedy decode steps through ``repro_torch.launch.steps``,
     requiring finite logits, exactly one ff_chunk_scan launch per layer
     and (zamba2) attention launches; prefill and decode times, peak
     memory, the bf16 handoff gap, a prefill profile (device busy time
     and the scan's share of it) and a decode-step profile, each compiled
     and eager (``compiled=False``) in the same call; then full-width,
     full-depth deepseek-v2-lite (27 layers, bf16 drawn and cast leaf by
     leaf) the same way, requiring finite logits, every compiled step
     equal to its eager step bit for bit and no kernel of the port
     launched (its MLA runs the reference's "xla" attention); then
     internvl2-1b (4 x 32 tokens after 256 random patch embeddings, rows
     1-2 launched) and whisper-tiny (4 x 32 tokens over 1500 random
     frames, no kernel launched: its attention is the reference's unfused
     path) the same way;
  f. time each kernel at the main path's shapes with CUDA events
     (attention also at the 256-token prefill, q/k/v [64,256,64], SDPA
     beside it; decode attention, contiguous and paged, at the default
     serve run's lengths, at the prompt-256 run's and on a long cache of
     4 x 16 KV heads at lengths 4096/3500/2900/2048, masked SDPA beside
     the contiguous one; the chunk scan at both recurrent models' prefill
     shapes at chunk 64 and 256, and its f32 ring body at N = P = 256 and
     at both models' shapes in f32, with where a block's cycles go), and
     each fused launch against its staged
     composition; then the paper's depth experiment: the matmul at both
     LIB shapes, the MoE dispatch, attention and attention_proj at q/k/v
     [64,256,64], the chunk scan at both models' prefill shapes (and in
     f32 at N = P = 256), and the
     decode layer's q-projection, SwiGLU and MLP tail at B = 4, and both
     decode-attention kernels at the prompt-256 and long shapes, and the
     gather at both LIB shapes, at every ring depth {1, 2, 3, 4, 6} x
     streams {1, 2}, and the gather also at streams 4, depth 8 and a
     grid cut to 33 blocks (a ``depth_sweep`` line); the f32 rings in the
     same sweep (the product at both LIB shapes and f32 x bf16 at wi,
     the gathered f32 dispatch, attention at both serve shapes, the f32
     decode-layer kernels at B = 4 at qwen's and qwen2-72b's widths); every
     f32 body at the shapes of its bf16 row, against its bound at 67
     TFLOP/s, its plain version and the f32 library call, the f32 MLP
     tail also against its staged launches (an ``f32_bodies`` line;
     ``--f32-timing`` builds and runs it alone);
  then each step kind replayed from its CUDA graph against the same step
     run eagerly from the same inputs, bit for bit (qwen's dense, paged
     and layer-graph decode and a prefill bucket at full width; the smoke
     rwkv6 and zamba2 prefill and decode in bf16), a replay's launch
     counts equal to an eager step's, and the cast-once weights equal to
     the per-use cast;
  g. profile full-width decode steps (dense, paged, layer graph; each
     compiled and eager, the six timed in alternating rounds in one
     call): wall vs device busy time, device kernels and host launch
     calls per step (a replay is one ``cudaGraphLaunch``), the
     decode-attention kernels' ms, launches and share of the busy time;
     for the layer graph the MLP tail's and the q-projection's launches
     (one each a layer, checked) and device ms per step (a ``profile``
     line keyed "<kind> compiled" / "<kind> eager"); the compiled steps
     also under the pre-policy constants (depth 2, streams 1: every qwen
     kernel's fixed ring before the pipe policy) and under ``baseline``
     (depth 1), timed in the same rounds ("<kind> compiled constants" /
     "<kind> compiled baseline"; "<kind> compiled" is the planner's
     ``ff``);
  h. the plan stack: full-width qwen1.5-0.5B served under ``ff`` (through
     ``serve_bench`` with ``--record-profile`` and ``--metrics-json``),
     ``baseline``, ``autotune`` and the constants, then ``python -m
     repro_torch.plans sweep`` on the card from the recorded profile into
     a PlanDB, then ``serve_bench --policy-mode autotune --plan-db`` from
     a cold plan cache; requiring the same greedy tokens in every run,
     paged == dense bit for bit in each, a metrics JSON that parses with
     the reference's names, PlanDB hits > 0 and no measurement inside a
     capture; with the planned (depth, streams) of every sweep case of
     phase f against the sweep's best and ``estimate_feedforward``'s
     prediction, the H100_SXM constants fitted from the gather's sweep,
     and the host cost of a resolution (a ``plans`` line).

  i. training, after the serve and steps runs (phase c-e): the smoke
     llama3.2-1b, qwen1.5-0.5B, grok-1, deepseek-v2-lite, rwkv6-7b,
     zamba2-2.7b, internvl2-1b and whisper-tiny models at f32 compute on
     the "xla" path, card against CPU: the loss within 2e-4, every
     gradient leaf within 1e-3 x its max |CPU value| (2e-3 the recurrent
     pair), one AdamW and one Adafactor update given the same gradients
     within 1e-5 of max |param|; full-width llama3.2-1b (the reference
     trainer's default model) through ``launch/train.py`` at batch 8 x 128
     tokens for 30 steps at lr 1e-3 in bf16 compute (f32 parameters,
     gradients and AdamW moments): every loss finite and the last five's
     mean below the first five's, with the median step, tokens/s, peak
     memory and the final checkpoint's size and write time (a ``train``
     line; the checkpoint goes to a temporary directory, removed after);
     4 more steps with ``--accum 2 --quantized-accum``, finite (no
     checkpoint: the first run's is the whole script's one full-width
     checkpoint write); both runs'
     steps compiled (one CUDA graph a signature) and the AdamW kernel the
     only kernel of the port they launch, twice a step (the model on the
     "xla" path, as the reference); the compiled step against the eager
     one from one state, 4 calls (the capture's warm-up, then 3 replays):
     full-width llama3.2-1b with the plain AdamW and with the kernel, and
     the smoke models above under AdamW and Adafactor and the smoke
     llama3.2-1b with int8 accumulation, params, optimizer
     state and metrics bit for bit (the MoE pair within 1e-3 in every
     metric and every leaf relative to its max: float atomics), one
     graph, no operand copied (a ``train_compiled`` line); the full-width
     kernel pair, after its checked calls, timed and profiled eager and
     compiled on the same states, 7 more calls each, still compared bit
     for bit (a ``train_profile`` line: wall and device ms, busy share,
     kernels and host launch calls a step, the AdamW kernel's share, peak
     memory, the top device ops, a bound; compiled: one graph launch a
     step and no other launch); a smoke run crashed at step 12 and
     resumed to 20 equal to a clean one bit for bit, the step compiled; a
     loss through the "ff" kernels with gradients on refused before any
     launch.

  j. (run right after the build, while this process holds nothing on
     the card) the distributed runtime, several ranks sharing it (NCCL
     refuses two ranks on one card, so they run gloo; every hop is
     host-staged): first a probe of each collective the runtime and
     DTensor issue on CUDA tensors over 4 gloo ranks (a ``dist_probe``
     line; gloo's send/recv cannot take CUDA tensors, so the ring hops run
     on ``gloo_staged``, probed too); then on 4 ranks every registry
     kernel with ``shard_dims`` sharded over "data" against its unsharded
     call (bit for bit, or within its tolerance where its launch plan is
     chosen from the rows, the reason printed), ``allgather_matmul`` and
     ``matmul_reducescatter`` with a policy at llama3.2-1b's widths
     ([1024, 2048] @ [2048, 8192] bf16 over model=2; ``ff_matmul``
     launched inside) against ``torch.matmul`` of the gathered operands;
     NCCL at world size 1 (an all-reduce; a smoke train step on DTensor
     state over the (1, 1) mesh against plain tensors, within 1e-6);
     on 2 ranks a smoke checkpoint written from 4 ranks restored onto
     ``survivable_mesh`` bit for bit, and llama3.2-1b's 16 full-width
     layers as a 2-stage GPipe of 4 microbatches against the layers in
     sequence (no_grad); last, full-width llama3.2-1b trained by
     ``launch/train.py`` for 3 steps at batch 8 x 128 on 1 rank and then
     under torchrun on 4 as (data 2, model 2), neither writing a
     checkpoint: step-1 loss within 1e-3
     relative of the 1-rank run and later steps within 5e-3, each rank's
     AdamW kernel launched twice a step (the 4 ranks on their shards, the
     norm's partial sums all-reduced) and no other kernel of the port,
     parameter bytes as the rules say, each rank's peak below 0.75 x the
     1-rank peak (a ``dist`` line: losses, step ms, tokens/s, peaks,
     collective bytes a step, the collectives' wall ms and hop bytes).

  k. (run right after phase j, while this process holds nothing on the
     card) ``python -m repro_torch.runtime.chaos suite --device cuda``
     (kill-restart, sigterm-drain, evict-remesh on 8 ranks, slow-host on
     2; each ``ok`` and ff_matmul launched in every worker), the four
     ``examples/*_torch.py`` on the card (train_tiny_lm cut to 30 of its
     300 steps), each required to reach its reference's last line, the
     ``core/feedforward`` specs (a k-tiled product, a row gather) against
     the ff_matmul and ff_gather kernels, and, beside them, the dry run of
     one full-width cell (qwen1.5-0.5B x train_4k on a 256-rank fake
     group) with its roofline row and wall (``chaos``, ``examples`` and
     ``dryrun`` lines; each part's wall on the ``k.`` line).

  l. (right after phase k) ``python -m torch.distributed.run
     --nproc-per-node 4 -m repro_torch.launch.serve --dist-backend
     gloo_staged --json ...``: full-width qwen1.5-0.5B (24 layers, bf16 as
     served), 8 requests of prompts <= 32 at rate 0, max-new 8, 4 slots,
     page 16, on the (data 2, model 2) mesh of the one card: every rank
     exits 0, rank 0's result has that mesh, paged == dense bit for bit,
     equal token counts, every rank's tokens the same, and rows 1-3
     launched on rank 0 (its wrappers' counts); beside it the same
     arguments on 1 rank in this process (compiled steps): the decode
     step ms of both and the share of tokens by rid equal (not gated; a
     ``mesh_serve_cli`` line). Then the StreamGraph layer and the mesh:
     each of
     the four registered graphs compiled by ``core/graph.py``
     ``compile_graph`` at its registered shapes in bf16, and the decode
     layer's at full-width qwen1.5-0.5B's widths: the fused plan's output
     == the direct ``spec.op`` launch bit for bit with one launch of the
     hand-fused kernel per fused chain (wrapper counts and the profiler's
     device kernels), ``prefer="staged"`` == ``spec.unfused`` bit for bit
     (``graph_plan`` lines: each edge's mode, rationale and bytes kept
     off device memory); full-width qwen1.5-0.5B (f32) served on 4 ranks
     of the card as (data 2, model 2) over ``gloo_staged``, uncompiled
     steps on DTensors: a prefill of 4 x 256 tokens and 8 greedy decode
     steps within 1e-3 of the 1-rank steps with equal tokens (step ms,
     peak GiB a rank); smoke grok-1 trained 3 steps with Adafactor on the
     same 4 ranks against 1 rank within 1e-3; ``serve_bench
     --layer-graph`` cut to 4 layers on the same ranks (every rank's
     tokens the same, rows 4 and 6 launched on rank 0; a
     ``mesh_serve_layer_graph`` line); and, beside them, the dry
     runs of qwen1.5-0.5B x prefill_32k and x decode_32k and grok-1 x
     train_4k on a 256-rank fake group with their roofline rows, then
     ``experiments/hillclimb_torch.py`` once on the prefill cell with one
     ``--patch`` (``mesh_serve``, ``mesh_adafactor`` and ``dryrun`` lines;
     each part's wall on the ``l.`` lines). The dry runs and the
     hillclimb are host work and run beside phases b-h; their checks
     come after phase h.

``python3 chip_smoke.py --dist`` builds the kernels and runs phase j
alone; ``--phase-l`` builds them and runs phase l alone.

``python3 chip_smoke.py --train-lr-sweep`` builds nothing and trains
full-width llama3.2-1b for phase i's 30 steps at lr 3e-4, 1e-3, 3e-3 and
1e-2 (one ``train_lr`` line: each run's losses).

``python3 chip_smoke.py --decode-timing`` builds the kernels and runs
only phase f's decode-attention timing (one ``decode_timing`` line): run
it in two trees in one call to compare their decode bodies.

Output: one line per check, per serve run (``serve[...]``, with its peak
memory) and per model driven through the steps (``model[...]``), a JSON
``kernels`` line, the
card's name and power limit as ``nvidia-smi`` reports them, and as the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
from argparse import Namespace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

F32_TOL, BF16_TOL, MODEL_TOL = 2e-4, 2e-2, 2e-4
LIB_F32_TOL = 5e-4                    # the reference registry's graph tol
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
SERVE = dict(arch="qwen1_5_0p5b", smoke=False, requests=16, prompt_len=32,
             max_new=16, page=16, slots=4, rate=10.0, eos_id=None,
             pool_blocks=None, seed=0, layer_graph=False, device="cuda",
             impl="ff", n_layers=None, policy_mode=None,
             record_profile=None, plan_db=None, metrics_json=None)
# grok-1 served at full width, cut to 2 of its 64 layers (64 are 1,179 GiB
# in f32): the serve defaults otherwise
GROK = dict(arch="grok1_314b", n_layers=2)
# deepseek-v2-lite at full width and depth (bf16, drawn and cast leaf by
# leaf from seed 0) through launch/steps: 4 x 256-token prompts, then 16
# greedy decode steps
DEEPSEEK = dict(arch="deepseek_v2_lite_16b", batch=4, prompt=256,
                decode_steps=16)
# internvl2-1b and whisper-tiny the same way, at full width and depth: 4
# prompts of 32 tokens after 256 random patch embeddings (internvl2-1b) or
# with 1500 random frames (whisper-tiny), then 16 greedy decode steps
INTERNVL = dict(arch="internvl2_1b", batch=4, prompt=32, decode_steps=16)
WHISPER = dict(arch="whisper_tiny", batch=4, prompt=32, decode_steps=16)
MOE_ARCHS = ("grok1_314b", "deepseek_v2_lite_16b")
# the other dense configs, the VLM and whisper: smoke models card vs CPU
# ((arch, with the VLM's patch embeddings)), full-width serve runs
# (label, overrides)
NEW_SMALL = (("llama3_2_1b", False), ("starcoder2_15b", False),
             ("qwen2_72b", False), ("internvl2_1b", True),
             ("internvl2_1b", False), ("whisper_tiny", True))
# rows 1-3 at each model's heads: (arch, name in the checks)
HEADS = (("grok1_314b", "grok-1"), ("llama3_2_1b", "llama3.2-1b"),
         ("internvl2_1b", "internvl2-1b"), ("starcoder2_15b", "starcoder2-15b"),
         ("qwen2_72b", "qwen2-72b"))
# qwen2-72b cut to 16 of its 80 layers (80 are 270.9 GiB in f32; 16 are
# 33 GB in bf16, drawn with a 31 GB f32 wi leaf beside them)
NEW_SERVE = (("llama3_2_1b", dict(arch="llama3_2_1b")),
             ("llama3_2_1b-layer-graph", dict(arch="llama3_2_1b",
                                              layer_graph=True)),
             ("starcoder2_15b", dict(arch="starcoder2_15b")),
             ("qwen2_72b", dict(arch="qwen2_72b", n_layers=16)),
             # its MLP tail at d 8192, d_ff 29568: k past 8192 (PR 28)
             ("qwen2_72b-layer-graph", dict(arch="qwen2_72b", n_layers=16,
                                            layer_graph=True)),
             ("internvl2_1b", dict(arch="internvl2_1b")))
KERNELS = {
    "ff_attention": dict(
        source="src/repro_torch/kernels/csrc/ff_attention.cu",
        replaces="src/repro/kernels/ff_attention/kernel.py:134"),
    "ff_decode_attention": dict(
        source="src/repro_torch/kernels/csrc/ff_decode_attention.cu",
        replaces="src/repro/kernels/ff_decode_attention/kernel.py:225"),
    "ff_paged_decode_attention": dict(
        source="src/repro_torch/kernels/csrc/ff_decode_attention.cu",
        replaces="src/repro/kernels/ff_decode_attention/kernel.py:125"),
    "ff_layer_matmul": dict(
        source="src/repro_torch/kernels/csrc/ff_layer.cu",
        replaces="src/repro/kernels/ff_layer/kernel.py:39"),
    "ff_layer_swiglu": dict(
        source="src/repro_torch/kernels/csrc/ff_layer.cu",
        replaces="src/repro/kernels/ff_layer/kernel.py:92"),
    "ff_layer_mlp_tail": dict(
        source="src/repro_torch/kernels/csrc/ff_layer.cu",
        replaces="src/repro/core/graph.py:783"),
    "ff_matmul": dict(
        source="src/repro_torch/kernels/csrc/ff_matmul.cu",
        replaces="src/repro/kernels/ff_matmul/kernel.py:94"),
    "ff_gather": dict(
        source="src/repro_torch/kernels/csrc/ff_gather.cu",
        replaces="src/repro/kernels/ff_gather/kernel.py:66"),
    "ff_attention_proj": dict(
        source="src/repro_torch/kernels/csrc/ff_attention_proj.cu",
        replaces="src/repro/models/layers.py:448"),
    "ff_dispatch_matmul": dict(
        source="src/repro_torch/kernels/csrc/ff_matmul.cu",
        replaces="src/repro/models/moe.py:222"),
    "ff_chunk_scan": dict(
        source="src/repro_torch/kernels/csrc/ff_chunk_scan.cu",
        replaces="src/repro/kernels/ff_chunk_scan/kernel.py:170",
        # the tensor-core body (bf16 q/k/v, the models' paths) and the f32
        # ring body (every other call)
        symbols=["ring_scan_kernel", "f32_ring_scan_kernel"]),
    # hand-fused, no Pallas counterpart: the update XLA fuses into the
    # reference's jitted train step
    "adamw": dict(
        source="src/repro_torch/kernels/csrc/adamw.cu",
        replaces="src/repro/optim/adamw.py:60"),
}
PER_OP = ("ff_attention", "ff_decode_attention", "ff_paged_decode_attention")
LAYER_GRAPH = PER_OP + ("ff_layer_matmul", "ff_layer_mlp_tail")
LIBRARY = ("ff_matmul", "ff_gather", "ff_attention_proj", "ff_dispatch_matmul")
# full-width shapes of the library path: (label, m, k, n) products,
# (label, rows, cols, n, dtype) gathers, (bh, s, d, d_out) for
# attention_proj, (tokens, d_model, n_dispatch, d_ff, t_out) for the MoE
LIB = dict(
    matmul=(("qwen1.5-0.5B wi, 4 x 256-token prefill", 1024, 1024, 5632),
            ("reference registry bench_kwargs", 4096, 4096, 4096)),
    gather=(("qwen1.5-0.5B embedding lookup", 152064, 1024, 1024,
             "bfloat16"),
            ("reference registry bench_kwargs", 1 << 20, 512, 1 << 20,
             "float32")),
    attention_proj=(64, 256, 64, 1024),
    moe=(512, 2048, 64, 1408, 64))
# the recurrent families' path: 4 prompts of 256 tokens, one prefill, then
# greedy decode steps; random f32 weights from seed 0
SSM = dict(archs=("rwkv6_7b", "zamba2_2p7b"), batch=4, prompt=256,
           decode_steps=16)
# a long-document decode on qwen1.5-0.5B (32K context): the serve run's 4
# slots at these lengths over 256 pages of 16 (a 64 MiB pool, 51.4 MB live)
DECODE_LONG = dict(n_pages=256, lengths=[4096, 3500, 2900, 2048])
SCAN_F32_TOL = 3e-5          # relative to max |plain|, the reference's bound
HANDOFF_TOL = 1e-3           # the reference registry's ff_chunk_scan tol
SSM_MODEL_TOL = 1e-3         # smoke SSMs card vs CPU: the same tol
# every qwen-path kernel's fixed ring before the pipe policy sized it
# (attention, decode attention, the paged decode, the decode-layer
# kernels: depth 2, streams 1), as one explicit policy
CONSTANTS = dict(depth=2, streams=1)
# phase i (training): the smoke models trained card vs CPU at f32 compute
# (loss relative, each gradient leaf relative to its max |CPU value|, one
# optimizer update given the same gradients relative to max |param|);
# full-width llama3.2-1b through launch/train.py (the reference trainer's
# default model), then its accumulation run; kill-and-resume at smoke
# width with the reference test's settings
TRAIN_SMALL = ("llama3_2_1b", "qwen1_5_0p5b", "grok1_314b",
               "deepseek_v2_lite_16b", "rwkv6_7b", "zamba2_2p7b",
               "internvl2_1b", "whisper_tiny")
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_SSM_GRAD_TOL = 2e-4, 1e-3, 2e-3
TRAIN_OPT_TOL = 1e-5
# lr 1e-3: at the trainer's default 3e-4 (20 warm-up steps) the last five
# losses' mean sat 0.005 below the first five's, within the steps'
# +-0.04 noise; 3e-3 and 1e-2 diverge in bf16 (--train-lr-sweep; PERF.md)
TRAIN = dict(arch="llama3_2_1b", batch=8, seq=128, steps=30, lr=1e-3,
             accum=2, accum_steps=4)
TRAIN_LRS = (3e-4, 1e-3, 3e-3, 1e-2)    # --train-lr-sweep
# the compiled train step: 4 calls (the capture's eager warm-up, then 3
# replays) against 4 eager steps from the same seed-0 state, at TRAIN's
# batch and lr; full-width llama3.2-1b once with the plain AdamW (a policy
# of mode "ref": the capture alone) and once with the kernel, bit for bit;
# TRAIN_SMALL's smoke models (compute as the trainer's) under AdamW and
# Adafactor at batch 2 x 32, the dense ones bit for bit, the MoE pair (whose
# index_add_ sums by float atomics in an order that changes from run to
# run, eager or replayed) reported and held to TRAIN_MOE_TOL relative in
# every metric
COMPILED_TRAIN_CALLS = 4
TRAIN_MOE = ("grok1_314b", "deepseek_v2_lite_16b")
TRAIN_MOE_TOL = 1e-3
# phase b's AdamW kernel on full-width llama3.2-1b's leaves (f32 params):
# one update from moments drawn at random at step ADAMW["step"], gradients
# whose norm clips; p, m and v each within ADAMW_TOL of its max |plain|,
# grad_norm and lr within ADAMW_TOL relative. The kernel sums the norm in
# double and in another order than the plain version's f32 sums, so a
# clipped step's scale moves by the plain sum's rounding (~1e-6); given
# one scale, its update, with FMA contraction off, is the plain version's
# bit for bit
ADAMW = dict(arch="llama3_2_1b", step=9, grad_scale=1e-3, lr=1e-3,
             reps=20, plain_reps=5)
ADAMW_TOL = 1e-5
KILL_RESUME = dict(arch="qwen1_5_0p5b", smoke=True, steps=20, batch=2,
                   seq=32, ckpt_every=5, fail_at=12)
# phase j (distributed): 4 ranks share the one card over gloo (NCCL refuses
# two ranks on one card); full-width llama3.2-1b trained by launch/train.py
# on 1 rank, then on 4 as (data 2, model 2), the loss held to the 1-rank
# run (step 1 relative, later steps relative); the collectives at
# llama3.2-1b's MLP widths ([m, k] @ [k, n]); GPipe of its 16 layers over 2
# stages of DIST["pipe_micro"] microbatches [pipe_mb, pipe_seq]
DIST = dict(ranks=4, arch="llama3_2_1b", batch=8, seq=128, steps=3,
            lr=1e-3, loss_tol=(1e-3, 5e-3), peak_frac=0.75,
            collective=(1024, 2048, 8192), collective_reps=5,
            pipe_micro=4, pipe_mb=2, pipe_seq=128, probe_timeout=40)
# what the runtime and DTensor issue (the first five) and the ring hops
DIST_PROBE = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
              "all_to_all_single", "broadcast", "batch_isend_irecv",
              "send_recv")
# registry kernels whose launch plan is chosen from the call's rows, so a
# shard's call may sum in another order than the whole call (held to the
# kernel's tolerance instead of bit for bit, with this reason printed)
SHARD_NOT_BITWISE = {
    "ff_matmul": "its tile and k split are chosen from m "
                 "(kernels/ff_matmul/ops.py _plan)",
    "ff_decode_attention": "its split of a row's live words over blocks is "
                           "planned from B (kernels/ff_decode_attention/"
                           "ops.py _plan)",
    "ff_chunk_scan": "its split of P over blocks is planned from the "
                     "rows (kernels/ff_chunk_scan/ops.py _plan)",
}
# the gather case the H100_SXM constants are fitted from
FIT_CASE = ("ff_gather table[1048576,512] float32 idx[1048576] "
            "(reference registry bench_kwargs)")

failures = []


def check(name, ok, detail):
    print(f"{'PASS' if ok else 'FAIL'} {name}: {detail}", flush=True)
    if not ok:
        failures.append(name)


def wrappers():
    from repro_torch.kernels.ff_attention import attention, attention_proj
    from repro_torch.kernels.ff_gather import gather
    from repro_torch.kernels.ff_matmul import dispatch_matmul, matmul
    from repro_torch.kernels.ff_decode_attention import decode_attention
    from repro_torch.kernels.ff_layer import (ff_layer_matmul,
                                              ff_layer_mlp_tail,
                                              ff_layer_swiglu)
    from repro_torch.kernels.ff_chunk_scan import chunk_scan
    from repro_torch.kernels.adamw import adamw_update
    from repro_torch.runtime.paged_kv import paged_decode_attention
    return {"ff_attention": attention, "ff_decode_attention": decode_attention,
            "ff_paged_decode_attention": paged_decode_attention,
            "ff_layer_matmul": ff_layer_matmul,
            "ff_layer_swiglu": ff_layer_swiglu,
            "ff_layer_mlp_tail": ff_layer_mlp_tail, "ff_matmul": matmul,
            "ff_gather": gather, "ff_attention_proj": attention_proj,
            "ff_dispatch_matmul": dispatch_matmul, "ff_chunk_scan": chunk_scan,
            "adamw": adamw_update}


def err(a, b):
    return (a.float() - b.float()).abs().max().item()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def prefill_inputs(torch, dev, dtype, bh, groups, s, d, gen):
    q = torch.randn(bh, s, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(bh // groups, s, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(bh // groups, s, d, generator=gen, device=dev).to(dtype)
    return q, k, v


def decode_inputs(torch, dev, dtype, b, h, kvh, d, page, n_pages, n_blocks,
                  lengths, gen):
    """A pool of stale random values, each row's reservation drawn from a
    permutation (sentinels past it), the same K/V also as a contiguous
    [B, S, KVH, D] cache viewed as [B, KVH, S, D]."""
    from repro_torch.runtime.paged_kv import paged_gather
    q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
    pool = torch.randn(n_blocks, 2, page, kvh, d, generator=gen,
                       device=dev).to(dtype)
    perm = torch.randperm(n_blocks, generator=gen, device=dev)
    tables = torch.full((b, n_pages), n_blocks, dtype=torch.int32, device=dev)
    used = 0
    for i, n in enumerate(lengths):
        need = min(n_pages, -(-n // page))
        tables[i, :need] = perm[used:used + need].int()
        used += need
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    k, v = paged_gather(pool, tables)
    return q, pool, tables, lens, k, v


# ---------------------------------------------------------------------------
# b. kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(torch, dev, shapes):
    from repro_torch.kernels.ff_attention import attention, attention_ref
    from repro_torch.kernels.ff_decode_attention import (decode_attention,
                                                         decode_attention_ref)
    from repro_torch.runtime.paged_kv import (paged_decode_attention,
                                              paged_decode_attention_ref)
    gen = torch.Generator(device=dev).manual_seed(1)
    main_err = {k: 0.0 for k in KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        tag = str(dtype).split(".")[1]
        for label, (bh, groups, s, d), causal in (
                ("serve", shapes["prefill"], True),
                ("serve-256", shapes["prefill_256"], True),
                ("wide", (16, 2, 1000, 64), True),
                ("wide-noncausal", (16, 2, 1000, 64), False)):
            q, k, v = prefill_inputs(torch, dev, dtype, bh, groups, s, d, gen)
            out = attention(q, k, v, kv_groups=groups, causal=causal)
            ref = attention_ref(q, k, v, kv_groups=groups, causal=causal)
            torch.cuda.synchronize()
            e = err(out, ref)
            check(f"ff_attention {label} {tag} bh={bh} g={groups} s={s}",
                  e <= tol and out.isfinite().all().item(),
                  f"max|kernel-plain|={e:.3e} tol={tol}")
            if label == "serve" and dtype == torch.bfloat16:
                main_err["ff_attention"] = e
            if label == "serve-256" and dtype == torch.bfloat16:
                check_pipe_bitwise(
                    torch, f"ff_attention {label} bh={bh} s={s}",
                    lambda **kw: attention(q, k, v, kv_groups=groups,
                                           causal=causal, **kw), out)
            if label in ("serve", "serve-256", "wide-noncausal") \
                    and dtype == torch.float32:
                check_pipe_bitwise(
                    torch, f"ff_attention {label} f32 bh={bh} s={s}",
                    lambda **kw: attention(q, k, v, kv_groups=groups,
                                           causal=causal, **kw), out,
                    attention_f32_grid(torch, d))
        for label, (b, h, kvh, d, page, n_pages, nb, lengths) in (
                *((lbl, tuple(shapes[key][f] for f in (
                    "b", "h", "kvh", "d", "page", "n_pages", "n_blocks",
                    "lengths"))) for lbl, key in (
                        ("serve", "decode"), ("serve-256", "decode_256"),
                        ("long", "decode_long"))),
                ("wide", (4, 16, 8, 64, 16, 64, 300, [0, 1000, 517, 1024])),
                ("gqa-page8", (3, 12, 2, 64, 8, 40, 200, [333, 0, 17]))):
            q, pool, tables, lens, k, v = decode_inputs(
                torch, dev, dtype, b, h, kvh, d, page, n_pages, nb, lengths,
                gen)
            out_c = decode_attention(q, k, v, lens, block_kv=page)
            out_p = paged_decode_attention(q, pool, tables, lens)
            ref_c = decode_attention_ref(q, k, v, lens, block_kv=page)
            ref_p = paged_decode_attention_ref(q, pool, tables, lens)
            torch.cuda.synchronize()
            e_c, e_p = err(out_c, ref_c), err(out_p, ref_p)
            inactive = [i for i, n in enumerate(lengths) if n == 0]
            zero = all(out_p[i].eq(0).all().item() for i in inactive)
            check(f"ff_decode_attention {label} {tag} b={b} h={h} kvh={kvh} "
                  f"pages={n_pages}", e_c <= tol,
                  f"max|kernel-plain|={e_c:.3e} tol={tol}")
            check(f"ff_paged_decode_attention {label} {tag} b={b} h={h} "
                  f"kvh={kvh} pages={n_pages}", e_p <= tol and zero,
                  f"max|kernel-plain|={e_p:.3e} tol={tol}, "
                  f"inactive rows exactly 0: {zero}")
            check(f"paged == contiguous bitwise {label} {tag}",
                  torch.equal(out_c, out_p), f"max diff {err(out_c, out_p)}")
            if label != "serve":
                check_decode_pipe(torch, f"{label} {tag}", q, k, v, pool,
                                  tables, lens, page, out_c)
            if label == "serve" and dtype == torch.bfloat16:
                main_err["ff_decode_attention"] = e_c
                main_err["ff_paged_decode_attention"] = e_p
    return main_err


def check_decode_pipe(torch, label, q, k, v, pool, tables, lens, page,
                      want):
    """Both decode kernels at every (depth, streams) of PIPE_GRID equal
    ``want`` (the contiguous kernel at the defaults) bit for bit: the ring
    changes when a word lands, never what is summed, and the paged kernel
    reads the same words as the contiguous one."""
    from repro_torch.kernels.ff_decode_attention import decode_attention
    from repro_torch.runtime.paged_kv import paged_decode_attention
    bad = []
    for depth, st in PIPE_GRID:
        out_c = decode_attention(q, k, v, lens, block_kv=page, depth=depth,
                                 streams=st)
        out_p = paged_decode_attention(q, pool, tables, lens, depth=depth,
                                       streams=st)
        if not (torch.equal(out_c, want) and torch.equal(out_p, want)):
            bad.append((depth, st))
    check(f"decode contiguous and paged {label} bitwise across depth x "
          f"streams {PIPE_GRID}", not bad,
          f"differs at {bad}" if bad else "all equal")


def layer_inputs(torch, dev, dtype, m, lay, gen):
    """Operands of the decode-layer kernels at ``m`` rows: the layer input
    x, an attention output a, f32 norm weights, weights scaled by
    1/sqrt(k), wg and wu as the two halves of one wi (as the model passes
    them), rope positions."""
    d, hq, f = lay["d"], lay["hq"], lay["f"]

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    wi = rn(d, 2 * f, scale=d ** -0.5).to(dtype)
    return dict(x=rn(m, d).to(dtype), a=rn(m, hq).to(dtype),
                nw1=1 + 0.1 * rn(d), nw2=1 + 0.1 * rn(d),
                wq=rn(d, hq, scale=d ** -0.5).to(dtype),
                bq=rn(hq, scale=0.1).to(dtype),
                wo=rn(hq, d, scale=hq ** -0.5).to(dtype), wi=wi,
                wg=wi[:, :f], wu=wi[:, f:],
                wo2=rn(f, d, scale=f ** -0.5).to(dtype),
                res=rn(m, hq).to(dtype), act=rn(m, f).to(dtype),
                pos=torch.randint(0, 4096, (m,), generator=gen, device=dev))


def tail_args(t):
    return (t["a"], t["wo"], t["x"], t["nw2"], t["wg"], t["wu"], t["wo2"])


def check_layer_kernels(torch, dev, shapes, name=None):
    """The three decode-layer kernels against their plain versions: the
    main path's q-projection (RMSNorm, q bias where the config has one,
    RoPE), SwiGLU and MLP tail at B = 4, then B in {1, 13, 16} with
    RMSNorm off and on and each epilogue; the tail also against its three
    staged launches, bit for bit. At B = 4 the three kernels bitwise
    across the ring's settings: bf16 over PIPE_GRID, f32 (the same ring
    body) over ``layer_f32_grid`` with the tail == staged at each. With
    ``name`` (another model's ``shapes``), its B = 4 case alone, checks
    named after it, its f32 kernels against the plain versions only."""
    from repro_torch.kernels.ff_layer import (ff_layer_matmul,
                                              ff_layer_matmul_ref,
                                              ff_layer_mlp_tail,
                                              ff_layer_mlp_tail_ref,
                                              ff_layer_swiglu,
                                              ff_layer_swiglu_ref,
                                              mlp_tail_staged)
    lay = shapes["layer"]
    gen = torch.Generator(device=dev).manual_seed(3)
    main_err = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        tag = str(dtype).split(".")[1]
        cases = (("serve", lay["b"]),) + (
            (("wide", 1), ("wide", 13), ("wide", 16)) if name is None else ())
        for label, m in cases:
            shown = label if name is None else f"{name} {label}"
            t = layer_inputs(torch, dev, dtype, m, lay, gen)
            rope = dict(bias=t["bq"] if lay["qkv_bias"] else None,
                        positions=t["pos"],
                        rope_theta=lay["theta"], head_dim=lay["hd"])
            if label == "serve":
                rope["positions"] = torch.tensor(lay["positions"], device=dev)
                mm_cases = [("rmsnorm", "rope")]
                sw_norms = [True]
            else:
                mm_cases = [(n, e) for n in ("plain", "rmsnorm")
                            for e in ("none", "rope", "residual")]
                sw_norms = [False, True]
            for norm, epi in mm_cases:
                kw = dict(norm_weight=t["nw1"] if norm == "rmsnorm" else None)
                kw.update(rope if epi == "rope" else
                          {"residual": t["res"]} if epi == "residual" else {})
                out = ff_layer_matmul(t["x"], t["wq"], **kw)
                ref = ff_layer_matmul_ref(t["x"], t["wq"], **kw)
                torch.cuda.synchronize()
                e = err(out, ref)
                check(f"ff_layer_matmul {shown} {tag} m={m} {norm} {epi}",
                      e <= tol and out.isfinite().all().item(),
                      f"max|kernel-plain|={e:.3e} tol={tol}")
                if label == "serve" and dtype == torch.bfloat16:
                    main_err["ff_layer_matmul"] = e
            for norm in sw_norms:
                nw = t["nw2"] if norm else None
                out = ff_layer_swiglu(t["x"], t["wg"], t["wu"], norm_weight=nw)
                ref = ff_layer_swiglu_ref(t["x"], t["wg"], t["wu"],
                                          norm_weight=nw)
                torch.cuda.synchronize()
                e = err(out, ref)
                check(f"ff_layer_swiglu {shown} {tag} m={m} "
                      f"{'rmsnorm' if norm else 'plain'}",
                      e <= tol and out.isfinite().all().item(),
                      f"max|kernel-plain|={e:.3e} tol={tol}")
                if label == "serve" and dtype == torch.bfloat16:
                    main_err["ff_layer_swiglu"] = e
            fused = ff_layer_mlp_tail(*tail_args(t))
            staged = mlp_tail_staged(*tail_args(t))
            ref = ff_layer_mlp_tail_ref(*tail_args(t))
            torch.cuda.synchronize()
            e = err(fused, ref)
            check(f"ff_layer_mlp_tail {shown} {tag} m={m}",
                  e <= tol and fused.isfinite().all().item(),
                  f"max|kernel-plain|={e:.3e} tol={tol}")
            check(f"ff_layer_mlp_tail == staged bitwise {shown} {tag} m={m}",
                  torch.equal(fused, staged),
                  f"max diff {err(fused, staged)}")
            if label != "serve" or (dtype == torch.float32 and name):
                continue
            q_kw = dict(norm_weight=t["nw1"], **rope)
            pipe_fns = (
                ("ff_layer_matmul qproj", lambda **p: ff_layer_matmul(
                    t["x"], t["wq"], **q_kw, **p)),
                ("ff_layer_swiglu", lambda **p: ff_layer_swiglu(
                    t["x"], t["wg"], t["wu"], norm_weight=t["nw2"], **p)),
                ("ff_layer_mlp_tail", lambda **p: ff_layer_mlp_tail(
                    *tail_args(t), **p)))
            if dtype == torch.bfloat16:
                main_err["ff_layer_mlp_tail"] = e
                grid = None
            else:
                # the f32 ring (one body with bf16) at the serve shape:
                # every kernel and the tail == staged at each setting
                grid = layer_f32_grid()
                check_pipe_bitwise(
                    torch, f"ff_layer_mlp_tail == staged {shown} f32 m={m}",
                    pipe_fns[2][1], staged, grid)
            short = "bf16" if dtype == torch.bfloat16 else "f32"
            for kname, fn in pipe_fns:
                check_pipe_bitwise(torch, f"{kname} {shown} {short} m={m}",
                                   fn, fn(), grid)
    return main_err


def layer_f32_grid():
    """The decode-layer ring's f32 cases (``f32_grid``): the stages and
    sums take the same shared memory in both types, so the deepest is
    ``MAX_DEPTH``; streams divide the reference's 8-row blocks."""
    from repro_torch.kernels.ff_layer import ops as LO
    return f32_grid(LO.MAX_DEPTH, LO.stream_options((1, 2, 4, 8)))


def within(out, ref, tol):
    """(ok, max |out - ref|): ok when |out - ref| <= tol + tol * |ref|
    everywhere (relative and absolute: from magnitude 4 a bfloat16 step
    exceeds 2e-2) and every output is finite."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    ok = bool((diff <= tol + tol * ref.abs()).all().item()
              and out.isfinite().all().item())
    return ok, diff.max().item()


def rn(torch, gen, dev, *shape, scale=1.0, dtype=None):
    x = torch.randn(*shape, generator=gen, device=dev) * scale
    return x if dtype is None else x.to(dtype)


def matmul_operands(torch, dev, gen, m, k, n, a_dtype, b_dtype=None):
    return (rn(torch, gen, dev, m, k, dtype=a_dtype),
            rn(torch, gen, dev, k, n, scale=k ** -0.5,
               dtype=b_dtype or a_dtype))


def gather_operands(torch, dev, gen, rows, cols, n, dtype):
    """A table and n indices drawn with repeats, in no order."""
    return (rn(torch, gen, dev, rows, cols, dtype=dtype),
            torch.randint(0, rows, (n,), generator=gen, device=dev,
                          dtype=torch.int32))


def attn_proj_operands(torch, dev, gen, bh, s, d, d_out, dtype):
    return (rn(torch, gen, dev, bh, s, d, dtype=dtype),
            rn(torch, gen, dev, bh, s, d, dtype=dtype),
            rn(torch, gen, dev, bh, s, d, dtype=dtype),
            rn(torch, gen, dev, d, d_out, scale=d ** -0.5, dtype=dtype))


def moe_operands(torch, dev, gen, t, d, n, f, t_out, dtype):
    """(idx, tokens, w1, comb) in the order of moe_dispatch_ffn."""
    return (torch.randint(0, t, (n,), generator=gen, device=dev,
                          dtype=torch.int32),
            rn(torch, gen, dev, t, d, dtype=dtype),
            rn(torch, gen, dev, d, f, scale=d ** -0.5, dtype=dtype),
            torch.randint(0, n, (t_out,), generator=gen, device=dev,
                          dtype=torch.int32))


def check_library_kernels(torch, dev, shapes):
    """The library kernels against their plain versions at the full-width
    shapes of LIB and at ragged ones (m, n, k not multiples of any tile,
    odd gather n, a 7-element row, 6,144 short rows), a float32 output within 5e-4 and a
    bfloat16 one within 2e-2 (by the output's type: both sides get the
    same operand values), the gather exactly; every (A, B) type pair of the matmul;
    each fused launch equal to its staged composition bit for bit: the
    MoE dispatch to gather then matmul, attention_proj to attention then
    matmul, the paged kernel to gather then contiguous decode. The f32
    and mixed products (row-strided ones too), the gathered f32 launch and
    the f32 attention_proj also at every f32 ring setting of
    ``f32_grid``, bit for bit (the last two equal to their staged
    compositions at each)."""
    from repro_torch.kernels.ff_attention import (attention, attention_proj,
                                                  attention_proj_ref)
    from repro_torch.kernels.ff_gather import gather, gather_ref
    from repro_torch.kernels.ff_matmul import (dispatch_matmul,
                                               dispatch_matmul_ref, matmul,
                                               matmul_ref)
    from repro_torch.models import moe as M
    from repro_torch.runtime import paged_kv as P
    gen = torch.Generator(device=dev).manual_seed(6)
    main_err = {}
    bf16, f32 = torch.bfloat16, torch.float32
    for dtype in (bf16, f32):
        tol = BF16_TOL if dtype == bf16 else LIB_F32_TOL
        tag = str(dtype).split(".")[1]
        main = dtype == bf16
        cases = [(lbl, m, k, n, dtype, dtype) for lbl, m, k, n in
                 LIB["matmul"]]
        cases += [("ragged", 333, 70, 517, dtype, other)
                  for other in (bf16, f32)]
        for lbl, m, k, n, ta, tb in cases:
            a, b = matmul_operands(torch, dev, gen, m, k, n, ta, tb)
            out = matmul(a, b)
            ok, e = within(out, matmul_ref(a, b), tol)   # out has A's type
            check(f"ff_matmul {lbl} {tag} x {str(tb)[6:]} {m}x{k}x{n}", ok,
                  f"max|kernel-plain|={e:.3e} tol={tol} (rel and abs)")
            if main and lbl == LIB["matmul"][0][0]:
                main_err["ff_matmul"] = e
            if main and ta == tb:
                check_pipe_bitwise(torch, f"ff_matmul {lbl} {m}x{k}x{n}",
                                   lambda **kw: matmul(a, b, **kw), out)
            elif not main:
                check_pipe_bitwise(
                    torch, f"ff_matmul {lbl} {tag} x {str(tb)[6:]} "
                    f"{m}x{k}x{n}", lambda **kw: matmul(a, b, **kw), out,
                    matmul_f32_grid(torch, a, b))
        # rows TMA cannot describe: a row stride of 203 elements, B read
        # from an odd column (f32: with a bf16 B too)
        for tb in (dtype,) if main else (f32, bf16):
            a = rn(torch, gen, dev, 150, 203, dtype=dtype)[:, 3:195]
            b = rn(torch, gen, dev, 192, 300, scale=0.07,
                   dtype=tb)[:, 1:261]
            out = matmul(a, b)
            ok, e = within(out, matmul_ref(a, b), tol)
            check(f"ff_matmul row-strided {tag} x {str(tb)[6:]} 150x192x260",
                  ok, f"max|kernel-plain|={e:.3e} tol={tol} (rel and abs)")
            if not main:
                check_pipe_bitwise(
                    torch, f"ff_matmul row-strided {tag} x {str(tb)[6:]}",
                    lambda **kw: matmul(a, b, **kw), out,
                    matmul_f32_grid(torch, a, b))
        cases = [(lbl, r, c, n) for lbl, r, c, n, t in LIB["gather"]
                 if t == tag] + [("ragged", 500, 7, 1001),
                                 ("ragged", 500, 64, 333),
                                 ("short rows", 3000, 64, 6144)]
        for lbl, r, c, n in cases:
            table, idx = gather_operands(torch, dev, gen, r, c, n, dtype)
            out = gather(table, idx)
            want = gather_ref(table, idx)
            same = torch.equal(out, want)
            check(f"ff_gather {lbl} {tag} [{r},{c}] n={n} exact", same,
                  f"max diff {err(out, want)}")
            if main and lbl == LIB["gather"][0][0]:
                main_err["ff_gather"] = err(out, want)
            check_gather_pipe(torch, f"ff_gather {lbl} {tag} [{r},{c}] n={n}",
                              table, idx, want)
            del table, out, want
        for lbl, (bh, s, d, d_out), causal in (
                ("full", LIB["attention_proj"], True),
                ("ragged", (6, 77, 64, 200), True),
                ("ragged-noncausal", (4, 45, 32, 72), False)):
            q, k, v, w = attn_proj_operands(torch, dev, gen, bh, s, d, d_out,
                                            dtype)
            fused = attention_proj(q, k, v, w, causal=causal)
            staged = matmul(attention(q, k, v, causal=causal).reshape(
                bh * s, d), w)
            ok, e = within(fused, attention_proj_ref(q, k, v, w,
                                                     causal=causal), tol)
            check(f"ff_attention_proj {lbl} {tag} bh={bh} s={s} "
                  f"d_out={d_out}", ok,
                  f"max|kernel-plain|={e:.3e} tol={tol} (rel and abs)")
            check(f"ff_attention_proj == attention then matmul bitwise "
                  f"{lbl} {tag}", torch.equal(fused, staged),
                  f"max diff {err(fused, staged)}")
            if main and lbl == "full":
                main_err["ff_attention_proj"] = e
                check_pipe_bitwise(
                    torch, f"ff_attention_proj {lbl} bh={bh} s={s}",
                    lambda **kw: attention_proj(q, k, v, w, causal=causal,
                                                **kw), fused)
            if not main:
                # == staged (checked above) at every f32 ring setting
                check_pipe_bitwise(
                    torch, f"ff_attention_proj == staged {lbl} f32 bh={bh} "
                    f"s={s}", lambda **kw: attention_proj(
                        q, k, v, w, causal=causal, **kw), staged,
                    attention_f32_grid(torch, d))
        for lbl, (t, d, n, f, t_out) in (("full", LIB["moe"]),
                                         ("ragged", (100, 70, 24, 130, 16))):
            idx, tokens, w1, comb = moe_operands(torch, dev, gen, t, d, n, f,
                                                 t_out, dtype)
            fused = dispatch_matmul(tokens, idx, w1)
            staged = matmul(gather(tokens, idx), w1)
            ok, e = within(fused, dispatch_matmul_ref(tokens, idx, w1), tol)
            check(f"ff_dispatch_matmul {lbl} {tag} tokens[{t},{d}] n={n} "
                  f"d_ff={f}", ok,
                  f"max|kernel-plain|={e:.3e} tol={tol} (rel and abs)")
            check(f"ff_dispatch_matmul == gather then matmul bitwise {lbl} "
                  f"{tag}", torch.equal(fused, staged),
                  f"max diff {err(fused, staged)}")
            if main:
                check_pipe_bitwise(
                    torch, f"ff_dispatch_matmul {lbl}",
                    lambda **kw: dispatch_matmul(tokens, idx, w1, **kw),
                    fused)
            else:
                # == gather then matmul (checked above) at every f32 ring
                # setting
                check_pipe_bitwise(
                    torch, f"ff_dispatch_matmul == gather then matmul {lbl} "
                    f"f32", lambda **kw: dispatch_matmul(tokens, idx, w1,
                                                         **kw), staged,
                    matmul_f32_grid(torch, tokens, w1))
            out = M.moe_dispatch_ffn(idx, tokens, w1, comb)
            unf = M._moe_graph_unfused(idx, tokens, w1, comb)
            check(f"moe_dispatch_ffn == unfused bitwise {lbl} {tag}",
                  torch.equal(out, unf), f"max diff {err(out, unf)}")
            if main and lbl == "full":
                main_err["ff_dispatch_matmul"] = e
        dec = shapes["decode"]
        q, pool, tables, lens, _, _ = decode_inputs(
            torch, dev, dtype, dec["b"], dec["h"], dec["kvh"], dec["d"],
            dec["page"], dec["n_pages"], dec["n_blocks"], dec["lengths"],
            gen)
        idx = P.gather_indices(tables, page=dec["page"], kv_heads=dec["kvh"],
                               n_blocks=dec["n_blocks"])
        staged = P.paged_decode_unfused(q, pool, idx, lens)
        fused = P.paged_decode_attention(q, pool, tables, lens)
        check(f"paged decode == gather then decode bitwise serve {tag}",
              torch.equal(staged, fused), f"max diff {err(staged, fused)}")
    return main_err


PIPE_GRID = [(d, st) for d in (1, 2, 4) for st in (1, 2)]


def f32_grid(deepest, streams):
    """The f32 rings' (depth, streams) cases: depth {1, 2, 4} and the
    deepest that fits, each at every stream count the tiles take."""
    return [(d, st) for d in sorted({1, 2, 4, deepest}) if d <= deepest
            for st in streams]


def matmul_f32_grid(torch, a, b):
    from repro_torch.kernels.ff_matmul import ops as MO
    return f32_grid(MO.max_depth(a.dtype, b.dtype),
                    MO.stream_options((1, 2, 4, 8, 16), a.dtype, b.dtype))


def attention_f32_grid(torch, d):
    from repro_torch.kernels.ff_attention import ops as AO
    return f32_grid(AO.max_depth(d, torch.float32),
                    AO.stream_options((1, 2, 4), torch.float32))


def check_pipe_bitwise(torch, label, fn, want, grid=None):
    """A kernel on the ring (the product, the dispatch, attention,
    attention_proj, bf16 and f32) at every (depth, streams) of ``grid``
    (PIPE_GRID unless given) equals ``want`` (the default's) bit for bit:
    the ring changes when a tile lands, not what is computed."""
    grid = PIPE_GRID if grid is None else grid
    bad = [(d, st) for d, st in grid
           if not torch.equal(fn(depth=d, streams=st), want)]
    check(f"{label} bitwise across depth x streams {grid}", not bad,
          f"differs at {bad}" if bad else "all equal")


def check_gather_pipe(torch, label, table, idx, want):
    """The gather at every ring depth up to its max_depth x streams {1, 2}
    equals ``want`` (the plain version's) bit for bit."""
    from repro_torch.kernels.ff_gather import gather, max_depth
    n, c = idx.shape[0], table.shape[1]
    bad, tried = [], 0
    for st in (1, 2):
        for d in range(1, max_depth(c, table.dtype,
                                    max(1, min(st, n // 8))) + 1):
            tried += 1
            if not torch.equal(gather(table, idx, depth=d, streams=st), want):
                bad.append((d, st))
    check(f"{label} exact at every depth up to max_depth x streams {{1, 2}}",
          not bad, f"differs at {bad[:8]} of {tried}" if bad
          else f"all {tried} equal")


def library_path(torch, dev, shapes, gen):
    """The calls of the library path at full width: (name, function,
    operands) with operands on the card."""
    from repro_torch import ops
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.runtime import paged_kv as P
    bf16 = torch.bfloat16
    calls = []
    for lbl, m, k, n in LIB["matmul"]:
        calls.append((f"ops.matmul {lbl}", ops.matmul,
                      matmul_operands(torch, dev, gen, m, k, n, bf16)))
    for lbl, r, c, n, t in LIB["gather"]:
        calls.append((f"ops.gather {lbl}", ops.gather, gather_operands(
            torch, dev, gen, r, c, n, getattr(torch, t))))
    calls.append(("attention_proj", L.attention_proj, attn_proj_operands(
        torch, dev, gen, *LIB["attention_proj"], bf16)))
    calls.append(("moe_dispatch_ffn", M.moe_dispatch_ffn, moe_operands(
        torch, dev, gen, *LIB["moe"], bf16)))
    dec = shapes["decode"]
    q, pool, tables, lens, _, _ = decode_inputs(
        torch, dev, bf16, dec["b"], dec["h"], dec["kvh"], dec["d"],
        dec["page"], dec["n_pages"], dec["n_blocks"], dec["lengths"], gen)
    idx = P.gather_indices(tables, page=dec["page"], kv_heads=dec["kvh"],
                           n_blocks=dec["n_blocks"])
    calls.append(("staged paged decode", P.paged_decode_unfused,
                  (q, pool, idx, lens)))
    return calls


def run_library_path(torch, dev, shapes):
    """The library path once at full width, every launch count set to 0
    just before and read just after; each of its kernels must have
    launched. Each output is then held against the same call on CPU copies
    of the operands (the plain versions): bfloat16 within 2e-2, float32
    within 5e-4 (relative and absolute), gathers exactly."""
    gen = torch.Generator(device=dev).manual_seed(7)
    calls = library_path(torch, dev, shapes, gen)
    wr = wrappers()
    for w in wr.values():
        w.launches = 0
    t0 = time.perf_counter()
    outs = [fn(*args) for _, fn, args in calls]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: wr[name].launches for name in LIBRARY}
    print("library path " + json.dumps({"wall_s": wall,
                                        "launches": launches}), flush=True)
    for name in LIBRARY:
        check(f"library path {name} launched", launches[name] > 0,
              f"{launches[name]} launches")
    for (label, fn, args), out in zip(calls, outs):
        want = fn(*[a.cpu() for a in args])
        if "gather" in label:
            ok, e = torch.equal(out.cpu(), want), err(out.cpu(), want)
            tol = "exact"
        else:
            tol = BF16_TOL if out.dtype == torch.bfloat16 else LIB_F32_TOL
            ok, e = within(out.cpu(), want, tol)
        check(f"library path {label} card vs cpu "
              f"{tuple(out.shape)} {str(out.dtype)[6:]}", ok,
              f"max|card-cpu|={e:.3e} tol={tol}")
        del want
    return launches


def uniq(idx):
    return int(idx.unique().numel())


def time_library_kernels(torch, dev, shapes):
    """The library kernels at the full widths of LIB (bf16 unless LIB says
    otherwise), each against its bound, its plain version and the library
    calls computing the same function (torch.matmul; torch.index_select;
    SDPA then torch.matmul; index_select then torch.matmul), and each fused
    launch against its staged composition: attention_proj against
    attention then matmul, moe_dispatch_ffn (dispatch launch + combine
    gather) against gather, matmul, gather, and the paged kernel against
    gather then contiguous decode, with each staged launch timed alone too.
    Bytes count each input read once (a gathered table: its distinct
    indexed rows) and each output written once; the staged bounds add the
    intermediates' round trips."""
    import torch.nn.functional as F
    from repro_torch.kernels.ff_attention import (attention, attention_proj,
                                                  attention_proj_ref)
    from repro_torch.kernels.ff_decode_attention import decode_attention
    from repro_torch.kernels.ff_gather import gather, gather_ref
    from repro_torch.kernels.ff_matmul import (dispatch_matmul,
                                               dispatch_matmul_ref, matmul,
                                               matmul_ref)
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.runtime import paged_kv as P
    gen = torch.Generator(device=dev).manual_seed(8)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16

    def row(shape, kernel, plain, library, nbytes, ops, dtype, n,
            library_note=None):
        print(f"f. timing {shape}", flush=True)
        r = dict(shape=shape, ms=time_ms(torch, kernel, n, flush),
                 ms_hot=time_ms(torch, kernel, n),
                 call_ms=call_ms(torch, kernel, max(n // 2, 5)),
                 plain_ms=time_ms(torch, plain, max(n // 10, 5), flush),
                 library_ms=time_ms(torch, library, n, flush),
                 bound=bound(nbytes, ops, dtype))
        if library_note:
            r["library"] = library_note
        return r

    rows = {name: [] for name in LIBRARY}
    for lbl, m, k, n in LIB["matmul"]:
        a, b = matmul_operands(torch, dev, gen, m, k, n, bf16)
        reps = 10 if m * n * k > 2 ** 34 else 100
        rows["ff_matmul"].append(row(
            f"a[{m},{k}] @ b[{k},{n}] bf16 ({lbl})", lambda: matmul(a, b),
            lambda: matmul_ref(a, b), lambda: torch.matmul(a, b),
            (m * k + k * n + m * n) * 2, 2 * m * n * k, "bfloat16", reps))
        del a, b
    for lbl, r, c, n, t in LIB["gather"]:
        table, idx = gather_operands(torch, dev, gen, r, c, n,
                                     getattr(torch, t))
        item = table.element_size()
        rows["ff_gather"].append(row(
            f"table[{r},{c}] {t}, idx[{n}] ({lbl})",
            lambda: gather(table, idx), lambda: gather_ref(table, idx),
            lambda: torch.index_select(table, 0, idx),
            (uniq(idx) + n) * c * item + n * 4, 0, t,
            20 if n > 2 ** 16 else 200))
        del table, idx
    graphs = {}

    bh, s, d, d_out = LIB["attention_proj"]
    q, k, v, w = attn_proj_operands(torch, dev, gen, bh, s, d, d_out, bf16)
    b_, h_ = SERVE["slots"], bh // SERVE["slots"]
    q4, k4, v4 = (x.view(b_, h_, s, d) for x in (q, k, v))
    io = (3 * bh * s * d + d * d_out + bh * s * d_out) * 2
    ops = 4 * d * bh * s * (s + 1) / 2 + 2 * bh * s * d * d_out
    sdpa_mm = lambda: torch.matmul(F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True).reshape(bh * s, d), w)
    shape = f"q/k/v[{bh},{s},{d}] causal, w[{d},{d_out}] bf16"
    rows["ff_attention_proj"].append(row(
        shape, lambda: attention_proj(q, k, v, w),
        lambda: attention_proj_ref(q, k, v, w), sdpa_mm, io, ops,
        "bfloat16", 100, "SDPA then torch.matmul"))
    inter = attention(q, k, v).reshape(bh * s, d)
    graphs["attention_proj"] = dict(
        shape=shape,
        fused_ms=rows["ff_attention_proj"][0]["ms"],
        unfused_ms=time_ms(torch, lambda: L._attention_proj_unfused(
            q, k, v, w), 100, flush),
        unfused_parts_ms=dict(
            attention=time_ms(torch, lambda: attention(q, k, v), 100, flush),
            matmul=time_ms(torch, lambda: matmul(inter, w), 100, flush)),
        library_ms=rows["ff_attention_proj"][0]["library_ms"],
        fused_bound=bound(io, ops, "bfloat16"),
        unfused_bound=bound(io + 2 * bh * s * d * 2, ops, "bfloat16"))

    t, d, n, f, t_out = LIB["moe"]
    idx, tokens, w1, comb = moe_operands(torch, dev, gen, t, d, n, f, t_out,
                                         bf16)
    disp = (uniq(idx) * d + d * f + n * f) * 2 + n * 4
    shape = (f"tokens[{t},{d}], idx[{n}], w1[{d},{f}] bf16 (the MoE "
             f"dispatch -> expert launch)")
    rows["ff_dispatch_matmul"].append(row(
        shape, lambda: dispatch_matmul(tokens, idx, w1),
        lambda: dispatch_matmul_ref(tokens, idx, w1),
        lambda: torch.matmul(torch.index_select(tokens, 0, idx), w1),
        disp, 2 * n * d * f, "bfloat16", 100,
        "index_select then torch.matmul"))
    combine = (uniq(comb) + t_out) * f * 2 + t_out * 4
    h = gather(tokens, idx)
    y = matmul(h, w1)
    graphs["moe_dispatch_ffn"] = dict(
        shape=shape.replace("(the MoE dispatch -> expert launch)",
                            f"comb[{t_out}]"),
        fused_ms=time_ms(torch, lambda: M.moe_dispatch_ffn(
            idx, tokens, w1, comb), 100, flush),
        unfused_ms=time_ms(torch, lambda: M._moe_graph_unfused(
            idx, tokens, w1, comb), 100, flush),
        unfused_parts_ms=dict(
            dispatch_gather=time_ms(torch, lambda: gather(tokens, idx), 100,
                                    flush),
            matmul=time_ms(torch, lambda: matmul(h, w1), 100, flush),
            combine_gather=time_ms(torch, lambda: gather(y, comb), 100,
                                   flush)),
        library_ms=time_ms(torch, lambda: torch.index_select(torch.matmul(
            torch.index_select(tokens, 0, idx), w1), 0, comb), 100, flush),
        fused_bound=bound(disp + combine, 2 * n * d * f, "bfloat16"),
        unfused_bound=bound(disp + combine + 2 * n * d * 2, 2 * n * d * f,
                            "bfloat16"))

    dec = shapes["decode"]
    q, pool, tables, lens, _, _ = decode_inputs(
        torch, dev, bf16, dec["b"], dec["h"], dec["kvh"], dec["d"],
        dec["page"], dec["n_pages"], dec["n_blocks"], dec["lengths"], gen)
    idx = P.gather_indices(tables, page=dec["page"], kv_heads=dec["kvh"],
                           n_blocks=dec["n_blocks"])
    live = sum(min(x, dec["n_pages"] * dec["page"]) for x in dec["lengths"])
    q_out = 2 * q.numel() * 2 + lens.numel() * 4
    kv_bytes = 2 * live * dec["kvh"] * dec["d"] * 2
    ops = 4 * dec["h"] * dec["d"] * live
    rows_bytes = idx.numel() * dec["d"] * 2  # every gathered row, once
    table = pool.reshape(-1, dec["d"])
    cache = gather(table, idx).view(2, dec["b"], dec["kvh"], -1, dec["d"])
    graphs["paged_decode"] = dict(
        shape=(f"q[{dec['b']},{dec['h']},{dec['d']}] lengths="
               f"{dec['lengths']} page={dec['page']} pages={dec['n_pages']} "
               f"bf16"),
        fused_ms=time_ms(torch, lambda: P.paged_decode_attention(
            q, pool, tables, lens), 200, flush),
        unfused_ms=time_ms(torch, lambda: P.paged_decode_unfused(
            q, pool, idx, lens), 200, flush),
        unfused_parts_ms=dict(
            gather=time_ms(torch, lambda: gather(table, idx), 200, flush),
            decode=time_ms(torch, lambda: decode_attention(
                q, cache[0], cache[1], lens, block_kv=dec["page"]), 200,
                flush)),
        library_ms=None,
        fused_bound=bound(q_out + kv_bytes + tables.numel() * 4, ops,
                          "bfloat16"),
        # the gather reads and writes every row of the tables, the decode
        # reads back the live ones
        unfused_bound=bound(q_out + idx.numel() * 4 + 2 * rows_bytes
                            + kv_bytes, ops, "bfloat16"))
    print("graphs " + json.dumps(graphs), flush=True)
    out = {}
    for name, (first, *more) in rows.items():
        out[name] = first
        if more:
            first["more"] = [split_bound(r) for r in more]
    return out


SWEEP_DEPTHS = (1, 2, 3, 4, 6)
SWEEP_STREAMS = (1, 2)
# the gather's extra cases: (key, keyword arguments of gather, the SM
# count its wrapper plans for: None for the card's own)
GATHER_EXTRA = (("depth=3 streams=4", dict(depth=3, streams=4), None),
                ("depth=4 grid=33", dict(), 33),
                ("depth=8 streams=1", dict(depth=8), None))


def gather_sms(sms):
    """A context in which the gather's wrapper plans for ``sms`` SMs (one
    block each, so a grid of ``sms`` blocks), or the card's own count."""
    import contextlib
    from unittest import mock
    from repro_torch.kernels.ff_gather import ops as GO
    if sms is None:
        return contextlib.nullcontext()
    return mock.patch.object(GO, "_sms", lambda index: sms)


def depth_sweep(torch, dev, shapes):
    """The paper's depth experiment on this card: rows 8 (both LIB shapes)
    and 8b, their f32 rings (both LIB shapes in f32, qwen's wi in f32 x
    bf16, the gathered f32 dispatch) and f32 attention at both serve
    shapes (q/k/v [64,32,64] and [64,256,64]), then row 1 and row 8a at
    q/k/v [64,256,64] (qwen's 4 x 256-token prefill; 8a into d_model
    1024), row 9 at both recurrent models' prefill shapes (chunk 64) and
    row 9 f32 (N = P = 256, chunk 256),
    then rows 4-6 at the serve shape (B = 4) in bf16, then in f32 there
    and at qwen2-72b's widths, row 7 (the gather) at both LIB shapes,
    then rows 2 and 3 at ``decode_256`` and ``decode_long``, device ms
    per call with L2 cold, at every depth of SWEEP_DEPTHS that fits in
    shared memory and every streams of SWEEP_STREAMS; then the gather at
    GATHER_EXTRA's settings, through its wrapper. Printed as one
    ``depth_sweep`` JSON line."""
    from repro_torch.kernels import ff_attention as A
    from repro_torch.kernels import ff_layer as FL
    from repro_torch.kernels.ff_layer import ops as FLO
    from repro_torch.kernels.ff_matmul import dispatch_matmul, matmul
    from repro_torch.kernels.ff_matmul.ops import MAX_DEPTH
    gen = torch.Generator(device=dev).manual_seed(10)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16
    cases = []
    for lbl, m, k, n in LIB["matmul"]:
        a, b = matmul_operands(torch, dev, gen, m, k, n, bf16)
        cases.append((f"ff_matmul a[{m},{k}] @ b[{k},{n}] ({lbl})",
                      lambda a=a, b=b, **kw: matmul(a, b, **kw),
                      10 if m * n * k > 2 ** 34 else 100, MAX_DEPTH))
    t, d, n, f, t_out = LIB["moe"]
    idx, tokens, w1, _ = moe_operands(torch, dev, gen, t, d, n, f, t_out,
                                      bf16)
    cases.append((f"ff_dispatch_matmul tokens[{t},{d}] idx[{n}] "
                  f"w1[{d},{f}]",
                  lambda **kw: dispatch_matmul(tokens, idx, w1, **kw), 100,
                  MAX_DEPTH))
    # the f32 rings: both products, the f32 x bf16 pair at qwen's wi, the
    # gathered dispatch, then attention at the serve shapes below
    f32 = torch.float32
    from repro_torch.kernels.ff_matmul import ops as MO
    for (lbl, m, k, n), tb in ((LIB["matmul"][0], f32), (LIB["matmul"][0],
                                                          bf16),
                               (LIB["matmul"][1], f32)):
        a, b = matmul_operands(torch, dev, gen, m, k, n, f32, tb)
        cases.append((f"ff_matmul f32 x {str(tb)[6:]} a[{m},{k}] @ "
                      f"b[{k},{n}] ({lbl})",
                      lambda a=a, b=b, **kw: matmul(a, b, **kw),
                      10 if m * n * k > 2 ** 34 else 100,
                      MO.max_depth(f32, tb)))
    t, d, n, f, t_out = LIB["moe"]
    f_idx, f_tokens, f_w1, _ = moe_operands(torch, dev, gen, t, d, n, f,
                                            t_out, f32)
    cases.append((f"ff_dispatch_matmul f32 tokens[{t},{d}] idx[{n}] "
                  f"w1[{d},{f}]",
                  lambda **kw: dispatch_matmul(f_tokens, f_idx, f_w1, **kw),
                  100, MO.max_depth(f32)))
    for key in ("prefill", "prefill_256"):
        a_bh, a_g, a_s, a_d = shapes[key]
        aq, ak, av = prefill_inputs(torch, dev, f32, a_bh, a_g, a_s, a_d, gen)
        cases.append((f"ff_attention f32 q[{a_bh},{a_s},{a_d}] causal",
                      lambda aq=aq, ak=ak, av=av, g=a_g, **kw: A.attention(
                          aq, ak, av, kv_groups=g, **kw), 100,
                      A.max_depth(a_d, f32)))
    bh, s, d, d_out = LIB["attention_proj"]
    q, k, v, w = attn_proj_operands(torch, dev, gen, bh, s, d, d_out, bf16)
    cases.append((f"ff_attention q/k/v[{bh},{s},{d}] causal",
                  lambda **kw: A.attention(q, k, v, **kw), 100,
                  A.max_depth(d)))
    cases.append((f"ff_attention_proj q/k/v[{bh},{s},{d}] causal, "
                  f"w[{d},{d_out}]",
                  lambda **kw: A.attention_proj(q, k, v, w, **kw), 100,
                  A.max_depth(d)))
    lay = shapes["layer"]
    t = layer_inputs(torch, dev, bf16, lay["b"], lay, gen)
    q_kw = dict(norm_weight=t["nw1"], bias=t["bq"], rope_theta=lay["theta"],
                head_dim=lay["hd"],
                positions=torch.tensor(lay["positions"], device=dev,
                                       dtype=torch.int32))
    from repro_torch.kernels.ff_chunk_scan import chunk_scan
    from repro_torch.kernels.ff_chunk_scan import ops as SO
    for label, bh, n, p, exclusive in scan_shapes():
        heads = 1 if exclusive else bh // SSM["batch"]
        sargs = [x.contiguous() if x is not None else None
                 for x in scan_operands(torch, dev, gen, bh, SSM["prompt"],
                                        n, p, exclusive, bf16, True, heads)]
        cases.append((f"ff_chunk_scan {label} prefill, chunk 64",
                      lambda sargs=sargs, inc=not exclusive, **kw:
                      chunk_scan(*sargs, inclusive=inc, chunk=64, **kw),
                      100, SO.max_depth(n, p, sargs[3].dtype)))
    # the f32 ring body at PERF.md's row 9 f32 shape
    wargs = scan_operands(torch, dev, gen, 16, 256, 256, 256, True,
                          torch.float32)
    cases.append(("ff_chunk_scan f32 N=P=256 exclusive+u, chunk 256",
                  lambda **kw: chunk_scan(*wargs, inclusive=False, chunk=256,
                                          **kw),
                  20, SO.f32_max_depth(256, 256)))
    for label, fn in (
            ("qproj", lambda **kw: FL.ff_layer_matmul(t["x"], t["wq"],
                                                      **q_kw, **kw)),
            ("swiglu", lambda **kw: FL.ff_layer_swiglu(
                t["x"], t["wg"], t["wu"], norm_weight=t["nw2"], **kw)),
            ("mlp_tail", lambda **kw: FL.ff_layer_mlp_tail(*tail_args(t),
                                                           **kw))):
        cases.append((f"ff_layer {label} B={lay['b']} (serve)", fn, 100,
                      FLO.MAX_DEPTH))
    # their f32 ring (one body with bf16) at the serve shape, and at
    # qwen2-72b's widths (k 8192 and 29568)
    for arch in (SERVE["arch"], "qwen2_72b"):
        f_lay = main_path_shapes(torch, arch)["layer"]
        ft = layer_inputs(torch, dev, f32, f_lay["b"], f_lay, gen)
        f_kw = dict(norm_weight=ft["nw1"], bias=ft["bq"],
                    rope_theta=f_lay["theta"], head_dim=f_lay["hd"],
                    positions=torch.tensor(f_lay["positions"], device=dev,
                                           dtype=torch.int32))
        where = "serve" if arch == SERVE["arch"] else arch
        for label, fn in (
                ("qproj", lambda ft=ft, f_kw=f_kw, **kw: FL.ff_layer_matmul(
                    ft["x"], ft["wq"], **f_kw, **kw)),
                ("swiglu", lambda ft=ft, **kw: FL.ff_layer_swiglu(
                    ft["x"], ft["wg"], ft["wu"], norm_weight=ft["nw2"],
                    **kw)),
                ("mlp_tail", lambda ft=ft, **kw: FL.ff_layer_mlp_tail(
                    *tail_args(ft), **kw))):
            cases.append((f"ff_layer {label} f32 B={f_lay['b']} ({where})",
                          fn, 100 if where == "serve" else 10,
                          FLO.MAX_DEPTH))
    from repro_torch.kernels import ff_gather as G
    gather_cases = []     # (names of their own: the lambdas above bind late)
    for lbl, g_r, g_c, g_n, g_t in LIB["gather"]:
        g_table, g_idx = gather_operands(torch, dev, gen, g_r, g_c, g_n,
                                         getattr(torch, g_t))
        label = f"ff_gather table[{g_r},{g_c}] {g_t} idx[{g_n}] ({lbl})"
        reps = 10 if g_n > 2 ** 16 else 100
        fn = (lambda g_table=g_table, g_idx=g_idx, **kw:
              G.gather(g_table, g_idx, **kw))
        cases.append((label, fn, reps, G.max_depth(g_c, g_table.dtype, 2)))
        gather_cases.append((label, fn, reps, G.gather_ref(g_table, g_idx)))
    from repro_torch.kernels.ff_decode_attention import ops as DO
    from repro_torch.runtime.paged_kv import paged_decode_attention
    for key in ("decode_256", "decode_long"):
        dec = shapes[key]
        dq, pool, tables, lens, dk, dv = decode_inputs(
            torch, dev, bf16, dec["b"], dec["h"], dec["kvh"], dec["d"],
            dec["page"], dec["n_pages"], dec["n_blocks"], dec["lengths"],
            gen)
        deepest = DO.max_depth(dec["d"], bf16, dec["h"] // dec["kvh"])
        cases.append((f"ff_decode_attention {key}",
                      lambda dq=dq, dk=dk, dv=dv, lens=lens, pg=dec["page"],
                      **kw: DO.decode_attention(dq, dk, dv, lens,
                                                block_kv=pg, **kw),
                      100, deepest))
        cases.append((f"ff_paged_decode_attention {key}",
                      lambda dq=dq, pool=pool, tables=tables, lens=lens,
                      **kw: paged_decode_attention(dq, pool, tables, lens,
                                                   **kw),
                      100, deepest))
    sweep = dict(constants=CONSTANTS,
                 depths=list(SWEEP_DEPTHS), streams=list(SWEEP_STREAMS),
                 ms={})
    sweep["planned"] = {}
    for label, fn, reps, max_depth in cases:
        print(f"f. depth sweep {label}", flush=True)
        sweep["ms"][label] = {
            f"depth={x} streams={st}": time_ms(
                torch, lambda x=x, st=st: fn(depth=x, streams=st), reps,
                flush)
            for x in sweep["depths"] if x <= max_depth
            for st in sweep["streams"]}
        sweep["planned"][label] = planned_vs_best(
            torch, fn, reps, flush, sweep["ms"][label])
    # the gather beyond the sweep: wider words (streams 4), a deeper ring,
    # and the grid cut to a quarter of the SMs at the default depth
    sweep["gather_words_and_grid"] = {}
    for label, fn, reps, want in gather_cases:
        print(f"f. gather words and grid {label}", flush=True)
        ms, bad = {}, []
        for key, kw, sms in GATHER_EXTRA:
            with gather_sms(sms):
                if not torch.equal(fn(**kw), want):
                    bad.append(key)
                ms[key] = time_ms(torch, lambda kw=kw: fn(**kw), reps, flush)
        check(f"{label} exact at every setting of GATHER_EXTRA", not bad,
              f"differs at {bad}" if bad else "all equal")
        sweep["gather_words_and_grid"][label] = ms
    print("depth_sweep " + json.dumps(sweep), flush=True)
    return sweep


def spy_resolutions():
    """Patch ``autotune.resolve_call`` (and with it ``resolve_graph``) to
    record every resolution as (op, policy, keywords, choice); returns
    the list and the function that restores the real one."""
    from repro_torch.core import autotune
    real, seen = autotune.resolve_call, []

    def spy(op, policy, **kw):
        choice = real(op, policy, **kw)
        seen.append((op, policy, kw, choice))
        return choice
    autotune.resolve_call = spy
    return seen, lambda: setattr(autotune, "resolve_call", real)


def planned_vs_best(torch, fn, reps, flush, swept):
    """One sweep case under the session policy (``ff``): the planner's
    (depth, streams) for it, its device ms (timed as the sweep times), the
    sweep's best and the constants' ms, and ``estimate_feedforward``'s
    prediction for both the plan and the best."""
    from repro_torch.core.pipe import Pipe
    from repro_torch.core.pipeline_model import estimate_feedforward
    seen, restore = spy_resolutions()
    try:
        fn()
    finally:
        restore()
    op, pol, kw, choice = seen[-1]

    def predicted(depth, streams):
        pipe = Pipe(tile=tuple(kw["tile"]), dtype=kw["dtype"], depth=depth,
                    streams=streams)
        return estimate_feedforward(kw["workload"], pol.hw,
                                    pipe).total_s * 1e3

    best = min(swept, key=swept.get)
    bd, bs = (int(x.split("=")[1]) for x in best.split())
    key = f"depth={choice.depth} streams={choice.streams}"
    planned_ms = swept.get(key) or time_ms(torch, fn, reps, flush)
    const = f"depth={CONSTANTS['depth']} streams={CONSTANTS['streams']}"
    return {"op": op, "depth_cap": kw["depth_cap"],
            "word_bytes": kw["workload"].word_bytes,
            "regular": kw["workload"].regular,
            "stream_options": list(pol.stream_options),
            "planned": key, "planned_ms": planned_ms,
            "planned_predicted_ms": predicted(choice.depth, choice.streams),
            "best": best, "best_ms": swept[best],
            "best_predicted_ms": predicted(bd, bs),
            "constants_ms": swept.get(const),
            "planned_over_best": planned_ms / swept[best]}


def fit_h100(sweep):
    """The five fitted constants of ``H100_SXM`` from the gather's sweep
    (FIT_CASE: 2^20 rows of 512 f32, words of 8 rows, each row read and
    written once): ``irregular_eff`` the best bytes/s over 3.35 TB/s;
    ``stream_bw_frac`` streams 1's best against the best (1.0 when within
    2%); ``dma_latency_s`` the word time at depth 1, streams 1 (the whole
    card streaming: an effective latency a word); ``contention_coeff``
    from depth 1's streams 2 against streams 1 (the model's exposed
    latency ``lat * (1 + c) / 2``); ``max_streams`` the most streams whose
    best is within 2% of the best."""
    ms = sweep["ms"][FIT_CASE]
    n, cols, item = 1 << 20, 512, 4
    words = n // 8
    nbytes = 2 * n * cols * item + n * 4
    best = min(ms.values())
    by_streams = {}
    for key, t in ms.items():
        st = int(key.split()[1].split("=")[1])
        by_streams[st] = min(by_streams.get(st, t), t)
    frac = best / by_streams[1]
    t1, t2 = ms["depth=1 streams=1"], ms["depth=1 streams=2"]
    return {"case": FIT_CASE,
            "irregular_eff": nbytes / (best * 1e-3) / HBM_BYTES_PER_S,
            "stream_bw_frac": 1.0 if frac >= 0.98 else frac,
            "dma_latency_s": t1 * 1e-3 / words,
            "contention_coeff": max(0.0, 2 * t2 / t1 - 1),
            "max_streams": max(st for st, t in by_streams.items()
                               if t <= best * 1.02),
            "best_ms": best, "depth1_ms": {"streams=1": t1,
                                           "streams=2": t2}}


def regular_fits(sweep):
    """What the regular ring kernels' sweeps say of the same constants.
    For each regular case: the shallowest depth within 2% of its best
    (``d_min``) and the word's service time at the card's rate; the
    planner's rule (depth = ceil(latency / service) + 1) then holds for a
    latency in ((d_min - 2), (d_min - 1)] services (at most one service
    when d_min is 1), per card word, and 132 times that per SM ring. Also
    streams 1's best against the case's best."""
    cases = {}
    for label, ms in sweep["ms"].items():
        plan = sweep["planned"][label]
        if not plan["regular"]:
            continue
        by_depth, by_streams = {}, {}
        for key, t in ms.items():
            dep, st = (int(x.split("=")[1]) for x in key.split())
            by_depth[dep] = min(by_depth.get(dep, t), t)
            by_streams[st] = min(by_streams.get(st, t), t)
        best = min(ms.values())
        d_min = min(x for x, t in by_depth.items() if t <= best * 1.02)
        svc = plan["word_bytes"] / HBM_BYTES_PER_S
        cases[label] = {"d_min": d_min, "service_ns": svc * 1e9,
                        "latency_ns": [max(d_min - 2, 0) * svc * 1e9,
                                       max(d_min - 1, 1) * svc * 1e9],
                        "streams1_over_best": by_streams[1] / best}
    lo = max((c["latency_ns"][0] for c in cases.values()), default=None)
    hi = min((c["latency_ns"][1] for c in cases.values()), default=None)
    return {"cases": cases, "latency_ns_all": [lo, hi],
            "streams1_over_best_worst": max(
                (c["streams1_over_best"] for c in cases.values()),
                default=None)}


def split_bound(r):
    """A timing row with its ``bound`` pair as ``bound_ms`` and
    ``bound_by``."""
    r = dict(r)
    r["bound_ms"], r["bound_by"] = r.pop("bound")
    return r


def adamw_operands(torch, dev, model):
    """Full-width f32 params (seed 0), gradients at ADAMW's scale, and an
    AdamW state with random moments at ADAMW's step."""
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, dev)
    grads = L.tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device=dev).mul_(ADAMW["grad_scale"]),
        params)
    state = adamw.init(params)
    for _, m in L.tree_leaves(state["m"]):
        m.normal_(generator=gen).mul_(ADAMW["grad_scale"])
    for _, v in L.tree_leaves(state["v"]):
        v.uniform_(generator=gen).mul_(ADAMW["grad_scale"] ** 2)
    state["step"].fill_(ADAMW["step"])
    return params, grads, state


def check_adamw_kernel(torch, dev):
    """The AdamW kernel against its plain version on full-width
    llama3.2-1b's leaves after one update (ADAMW, ADAMW_TOL); then its
    time, the plain version's and ``torch._fused_adamw_``'s on the same
    leaves (no clipping: the library yardstick, timed only), beside the
    bound: every parameter, gradient and moment read once, the parameter
    and both moments written once. Returns ({"adamw": max abs error of
    the parameters}, the timing row)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.adamw import (MAX_LEAVES, adamw_ref,
                                           adamw_update)
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    model = build_model(get_config(ADAMW["arch"]))
    ocfg = adamw.AdamWConfig(lr_peak=ADAMW["lr"], warmup_steps=20,
                             total_steps=TRAIN["steps"])
    params, grads, state = adamw_operands(torch, dev, model)
    p_plain, s_plain = tree_clone(params), tree_clone(state)
    adamw_update.launches = 0
    _, _, mk = adamw_update(ocfg, grads, state, params)
    _, _, mp = adamw_ref(ocfg, grads, s_plain, p_plain)
    torch.cuda.synchronize()
    launched = adamw_update.launches
    rel, abs_p = {}, 0.0
    for name, got, want in (("p", params, p_plain),
                            ("m", state["m"], s_plain["m"]),
                            ("v", state["v"], s_plain["v"])):
        w = dict(L.tree_leaves(want))
        errs = [err(g, w[path]) for path, g in L.tree_leaves(got)]
        scale = max(w[path].abs().max().item() for path, _ in
                    L.tree_leaves(got))
        rel[name] = max(errs) / scale
        if name == "p":
            abs_p = max(errs)
    rel.update({k: abs(mk[k].item() - mp[k].item()) / abs(mp[k].item())
                for k in ("grad_norm", "lr")})
    n = model.param_count()
    leaves = len(list(L.tree_leaves(params)))
    check(f"adamw kernel == plain on full-width {ADAMW['arch']} "
          f"({n} params, {leaves} leaves, step {ADAMW['step'] + 1})",
          all(e <= ADAMW_TOL for e in rel.values())
          and launched == 2 * -(-leaves // MAX_LEAVES)
          and mk["grad_norm"].item() > ocfg.clip_norm,
          f"relative errors {json.dumps(rel)} (tol {ADAMW_TOL}); grad_norm "
          f"{mk['grad_norm'].item():.6f} (clips at {ocfg.clip_norm}); "
          f"launches {launched}")
    ms = time_ms(torch, lambda: adamw_update(ocfg, grads, state, params),
                 ADAMW["reps"])
    plain_ms = time_ms(torch, lambda: adamw_ref(ocfg, grads, s_plain,
                                                 p_plain),
                       ADAMW["plain_reps"])
    del p_plain, s_plain
    torch.cuda.empty_cache()
    pl = [p for _, p in L.tree_leaves(params)]
    g_l = dict(L.tree_leaves(grads))
    m_l, v_l = dict(L.tree_leaves(state["m"])), dict(L.tree_leaves(state["v"]))
    paths = [path for path, _ in L.tree_leaves(params)]
    steps_l = [torch.full((), float(ADAMW["step"] + 1), device=dev)
               for _ in pl]

    def library():
        torch._fused_adamw_(
            pl, [g_l[q] for q in paths], [m_l[q] for q in paths],
            [v_l[q] for q in paths], [], steps_l, lr=ocfg.lr_peak,
            beta1=ocfg.b1, beta2=ocfg.b2, weight_decay=ocfg.weight_decay,
            eps=ocfg.eps, amsgrad=False, maximize=False)
    library_ms = time_ms(torch, library, ADAMW["reps"])
    nbytes = sum(p.numel() * (2 * p.element_size() + g_l[q].element_size()
                              + 16) for q, p in zip(paths, pl))
    row = {"shape": f"full-width {ADAMW['arch']}: {leaves} leaves, {n} "
                    f"f32 params and gradients", "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound": bound(nbytes, 20 * n, "float32"),
           "launches_a_call": launched}
    print("adamw " + json.dumps({**split_bound(row), "rel_err": rel,
                                 "card": smi_line()}), flush=True)
    del params, grads, state, pl, g_l, m_l, v_l
    torch.cuda.empty_cache()
    return {"adamw": abs_p}, row


def check_decode_layer(torch, dev, shapes):
    """A full-width decode layer on the card (three launches) against its
    plain version on the CPU, bf16, at the main path's decode shapes."""
    from repro_torch.models import layers as L
    lay, dec = shapes["layer"], shapes["decode"]
    b, kvh, hd, page = dec["b"], dec["kvh"], dec["d"], dec["page"]
    gen = torch.Generator(device=dev).manual_seed(4)
    dt = torch.bfloat16
    t = layer_inputs(torch, dev, dt, b, lay, gen)
    cache = torch.randn(b, dec["n_pages"] * page, 2 * kvh, hd, generator=gen,
                        device=dev).to(dt)       # [B, S, KVH, hd] views
    lengths = torch.tensor(dec["lengths"], dtype=torch.int32, device=dev)
    k, v = cache[:, :, :kvh].transpose(1, 2), cache[:, :, kvh:].transpose(1, 2)
    args = (t["x"], t["nw1"], t["wq"], t["bq"], lengths - 1, k, v, lengths,
            t["wo"], t["nw2"], t["wg"], t["wu"], t["wo2"])
    out = L.decode_layer(*args, rope_theta=lay["theta"], block_kv=page).cpu()
    ref = L.decode_layer_ref(*[a.cpu() for a in args],
                             rope_theta=lay["theta"]).float()
    e = err(out, ref)
    excess = ((out.float() - ref).abs() - BF16_TOL * ref.abs()).max().item()
    check(f"decode_layer full width bf16 card vs cpu b={b} "
          f"h={lay['hq'] // hd}",
          excess <= BF16_TOL and out.isfinite().all().item(),
          f"max|card-cpu|={e:.3e}, beyond rtol: {excess:.3e} "
          f"tol={BF16_TOL} (rel and abs)")



def check_model_small(torch, dev, impl="ff"):
    """The smoke model on the card against the same model (plain kernel
    versions) on the CPU: prefill, then 3 decode steps through the dense
    cache, the paged pool and (under ``impl="ff"``) the layer graph (a
    dense cache). Under ``impl="xla"`` the attention is the reference's
    unfused plain path on both sides (``--impl xla``)."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import build_model
    from repro_torch.runtime.paged_kv import PagedKVCache
    cfg = smoke_config("qwen1_5_0p5b").replace(attn_impl=impl)
    if impl == "ff":
        cfg = cfg.replace(decode_block_kv=8)
    model = build_model(cfg)
    graph_model = build_model(cfg.replace(layer_graph=True))
    params_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    lens = [5, 19]
    toks = torch.zeros(2, 19, dtype=torch.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = torch.randint(1, cfg.vocab, (n,),
                                    generator=torch.Generator().manual_seed(i))

    def run(device, kind):
        params = tree_to(params_cpu, device, torch)
        m = graph_model if kind == "layer-graph" else model
        prefill = steps.make_prefill_step(m)
        decode = steps.make_decode_step(m)
        logits0, dense = prefill(params, {"tokens": toks.to(device)})
        if kind == "paged":
            kv = PagedKVCache(n_layers=cfg.n_layers, n_blocks=7, page=8,
                              kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                              n_slots=2, n_pages_max=3, dtype=cfg.cdtype,
                              device=device)
            for i, n in enumerate(lens):
                kv.admit(i, dense["k"][:, i], dense["v"][:, i], n, 24)
            cache = kv.cache_view()
        else:
            cache = serve.pad_cache_to(dense, 19, 24, 2)
        cur = toks[torch.arange(2), torch.tensor(lens) - 1].to(device)
        lengths = (torch.tensor(lens, dtype=torch.int32) - 1).to(device)
        out = [logits0.cpu()]
        for _ in range(3):
            cur, logits, cache = decode(params, {"token": cur,
                                                 "lengths": lengths}, cache)
            out.append(logits.cpu())     # the next replay overwrites it
            if kind == "paged":
                kv.update(cache)
            lengths = lengths + 1
        return out

    kinds = ("dense", "paged") + (("layer-graph",) if impl == "ff" else ())
    for kind in kinds:
        got, want = run(dev, kind), run(torch.device("cpu"), kind)
        e = max(err(g, w) for g, w in zip(got, want))
        same = all(torch.equal(g.argmax(-1), w.argmax(-1))
                   for g, w in zip(got, want))
        finite = all(g.isfinite().all().item() for g in got)
        tag = kind if impl == "ff" else f"{kind}, --impl {impl}"
        check(f"smoke model on card vs cpu ({tag})",
              e <= MODEL_TOL and same and finite,
              f"max|logits diff|={e:.3e} tol={MODEL_TOL}, greedy equal: "
              f"{same}, finite: {finite}")


def tree_to(tree, device, torch):
    if isinstance(tree, dict):
        return {k: tree_to(v, device, torch) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# b (slice 4). the chunk scan, attention at head dim 80, the smoke SSMs
# ---------------------------------------------------------------------------


def scan_shapes():
    """The chunk scan's shapes on the two models' prefill: (label, bh, n, p,
    exclusive), at SSM's batch and prompt length."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import mamba2, rwkv6
    rw, zb = get_config("rwkv6_7b"), get_config("zamba2_2p7b")
    nh, hd = rwkv6._dims(rw)
    _, znh, zn, zhd = mamba2._dims(zb)
    b = SSM["batch"]
    return (("rwkv6-7b", b * nh, hd, hd, True),
            ("zamba2-2.7b", b * znh, zn, zhd, False))


def scan_operands(torch, dev, gen, bh, s, n, p, exclusive, dtype,
                  model_types=False, heads=1):
    """q, k, v, log_w, u as the reference test draws them. With
    ``model_types`` the streams take the model's types: RWKV6 (exclusive)
    bf16 q/k/v/log_w and an f32 u, Mamba2 (inclusive) bf16 q/k/v and an
    f32 log_w. With ``heads`` > 1 they are laid out as Mamba2 lays them
    out: q and k shared by ``heads`` consecutive rows, log_w one value per
    row and step, expanded across N (views; the wrapper copies them)."""
    rows = bh // heads
    q = rn(torch, gen, dev, rows, s, n, scale=0.5)
    k = rn(torch, gen, dev, rows, s, n, scale=0.5)
    if heads > 1:
        q, k = (x[:, None].expand(rows, heads, s, n).reshape(bh, s, n)
                for x in (q, k))
        lw = -0.5 * torch.exp(rn(torch, gen, dev, bh, s, 1)).expand(bh, s, n)
    else:
        lw = -0.5 * torch.exp(rn(torch, gen, dev, bh, s, n))
    v = rn(torch, gen, dev, bh, s, p)
    u = rn(torch, gen, dev, bh, n, scale=0.3) if exclusive else None
    if model_types:
        lw_t = dtype if exclusive else torch.float32
        return q.to(dtype), k.to(dtype), v.to(dtype), lw.to(lw_t), u
    return q.to(dtype), k.to(dtype), v.to(dtype), lw.to(dtype), u


def scan_err(out, plain):
    return err(out, plain) / (plain.float().abs().max().item() + 1e-6)


def check_scan_kernel(torch, dev):
    """ff_chunk_scan against its plain version on the card: both models'
    prefill shapes (B = 4, S = 256, the models' stream types and f32) at
    chunk 64 and at chunk 256 (the reference autotuner's largest), then a
    ragged S = 200 at chunk 32/64/128 and N = P = 128 and 256 at chunk 256
    with S = 300, f32 and bf16, with and without u, and the strong-decay
    case (lw
    = -3, a chunk's decay e^-192) in f32 and bf16. f32 within 3e-5 of max
    |plain|, bf16 within 2e-2; the f32 cases also against the naive scan.
    The bf16 scan (the ring body) at both models' prefill shapes is then
    equal bit for bit across the ring's depth x streams (PIPE_GRID), and
    the f32 scan (the f32 ring body) at both models' prefill shapes and at
    N = P = 256 across depth {1, 2, 4, its deepest} x streams {1, 2, 4}.
    Last, the f32 body over a long row (S = 4096) at one decay near 1:
    within SCAN_F32_TOL of the float64 scan, and no further from it than
    the f32 naive scan."""
    from repro_torch.kernels.ff_chunk_scan import (chunk_scan,
                                                   chunk_scan_plain,
                                                   chunk_scan_ref,
                                                   f32_max_depth, max_depth)
    gen = torch.Generator(device=dev).manual_seed(9)
    s = SSM["prompt"]
    main_err = None
    cases = []
    for label, bh, n, p, exclusive in scan_shapes():
        heads = 1 if exclusive else bh // SSM["batch"]
        for chunk in (64, 256):
            for dtype in (torch.bfloat16, torch.float32):
                cases.append((f"{label} path" + (f" chunk={chunk}" if
                                                 chunk != 64 else ""),
                              bh, s, n, p, exclusive, chunk, dtype,
                              dtype == torch.bfloat16, heads))
    for chunk in (32, 64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            for exclusive in (False, True):
                cases.append((f"ragged chunk={chunk}", 8, 200, 64, 64,
                              exclusive, chunk, dtype, False, 1))
    for dtype in (torch.bfloat16, torch.float32):
        for exclusive in (False, True):
            cases.append(("N=P=128 chunk=256", 4, 300, 128, 128, exclusive,
                          256, dtype, False, 1))
            # the f32 ring body in both types: N = 256 (8 slices of 32
            # columns, at most three 51 KB stages in f32)
            cases.append(("N=P=256 chunk=256", 4, 300, 256, 256, exclusive,
                          256, dtype, False, 1))
            # 16 state rows a thread, one stage in f32
            cases.append(("N=512 P=64 chunk=128", 1, 200, 512, 64,
                          exclusive, 128, dtype, False, 1))
    for (label, bh, s_, n, p, exclusive, chunk, dtype, model_types,
         heads) in cases:
        ops_ = scan_operands(torch, dev, gen, bh, s_, n, p, exclusive, dtype,
                             model_types, heads)
        kw = dict(inclusive=not exclusive, chunk=chunk)
        out = chunk_scan(*ops_, **kw)
        plain = chunk_scan_plain(*ops_, **kw)
        torch.cuda.synchronize()
        tol = BF16_TOL if dtype == torch.bfloat16 else SCAN_F32_TOL
        e = scan_err(out, plain)
        detail = f"max|kernel-plain|/max|plain|={e:.3e} tol={tol}"
        ok = e < tol and out.isfinite().all().item()
        if dtype == torch.float32:
            e_ref = scan_err(out, chunk_scan_ref(*ops_,
                                                 inclusive=not exclusive))
            ok = ok and e_ref < tol
            detail += f", vs naive scan {e_ref:.3e}"
        mode = "exclusive+u" if exclusive else "inclusive"
        tag = str(dtype).split(".")[1] + (" model types" if model_types
                                          else "")
        check(f"ff_chunk_scan {label} {tag} {mode} bh={bh} s={s_} n={n} "
              f"p={p}", ok, detail)
        if label == "rwkv6-7b path" and model_types:
            main_err = err(out, plain)
        if label.endswith("path") and model_types:
            check_pipe_bitwise(torch, f"ff_chunk_scan {label} {mode}",
                               lambda **pk: chunk_scan(*ops_, **kw, **pk),
                               out)
        if dtype == torch.float32 and (label.endswith("path")
                                       or label.startswith("N=P=256")):
            # the f32 ring body: every depth up to its deepest
            check_pipe_bitwise(
                torch, f"ff_chunk_scan f32 {label} {mode}",
                lambda **pk: chunk_scan(*ops_, **kw, **pk), out,
                f32_grid(f32_max_depth(n, p), (1, 2, 4)))
    ones = torch.ones(2, 256, 64, device=dev)
    lw = torch.full((2, 256, 64), -3.0, device=dev)
    for exclusive in (False, True):
        u = torch.ones(2, 64, device=dev) if exclusive else None
        ref = chunk_scan_ref(ones, ones, ones, lw, u, inclusive=not exclusive)
        mode = "exclusive+u" if exclusive else "inclusive"
        out = chunk_scan(ones, ones, ones, lw, u, inclusive=not exclusive)
        e = err(out, ref)
        ok = bool(out.isfinite().all().item() and torch.allclose(
            out, ref, rtol=1e-4, atol=1e-5))
        check(f"ff_chunk_scan strong decay lw=-3 float32 {mode}", ok,
              f"finite, max|kernel-naive|={e:.3e} (rtol 1e-4, atol 1e-5)")
        b = ones.to(torch.bfloat16)
        out = chunk_scan(b, b, b, lw, u, inclusive=not exclusive)
        e = scan_err(out, ref)
        check(f"ff_chunk_scan strong decay lw=-3 bfloat16 {mode}",
              bool(out.isfinite().all().item()) and e < BF16_TOL,
              f"finite, max|kernel-naive|/max|naive|={e:.3e} "
              f"tol={BF16_TOL}")
    # a long row at one decay near 1: the carried state's decay must not
    # drift with S. The f32 naive scan drifts by itself (the rounding of
    # its per-row exp compounds), so the float64 scan is the yardstick and
    # the kernel must lie no further from it than the naive scan
    for lw_c in (-1e-3, -1e-4):
        for exclusive in (False, True):
            q, k, v, _, u = scan_operands(torch, dev, gen, 2, 4096, 64, 64,
                                          exclusive, torch.float32)
            lw_l = torch.full_like(q, lw_c)
            inc = not exclusive
            out = chunk_scan(q, k, v, lw_l, u, inclusive=inc)
            exact = scan_f64(torch, q, k, v, lw_l, u, inc)
            naive = chunk_scan_ref(q, k, v, lw_l, u, inclusive=inc)
            e, e_naive = scan_err(out, exact), scan_err(naive, exact)
            ok = e < SCAN_F32_TOL and e <= e_naive
            detail = (f"vs float64 {e:.3e}, the f32 naive scan vs float64 "
                      f"{e_naive:.3e}, kernel vs naive "
                      f"{scan_err(out, naive):.3e}")
            mode = "exclusive+u" if exclusive else "inclusive"
            check(f"ff_chunk_scan f32 long row S=4096 lw={lw_c} {mode}", ok,
                  f"{detail} tol={SCAN_F32_TOL}")
    return {"ff_chunk_scan": main_err}


def scan_f64(torch, q, k, v, log_w, u, inclusive):
    """The naive scan in float64: the exact result to f32's eyes."""
    q, k, v = q.double(), k.double(), v.double()
    lw = torch.clamp(log_w.double(), max=0.0)
    h = torch.zeros(q.shape[0], q.shape[2], v.shape[2], dtype=torch.float64,
                    device=q.device)
    ys = []
    for t in range(q.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        h_new = torch.exp(lw[:, t])[:, :, None] * h + kv
        eff = h_new if inclusive else h + u.double()[:, :, None] * kv
        ys.append(torch.einsum("bn,bnp->bp", q[:, t], eff))
        h = h_new
    return torch.stack(ys, dim=1)


# a dense config's head dim 128: qwen2-72b's 64 q heads over 8 KV heads
# (src/repro/configs/qwen2_72b.py), one prompt of 256 tokens
HD128 = dict(heads=64, kv_heads=8, d=128, s=256)


def check_attention_head_dims(torch, dev):
    """Zamba2's shared attention block at its head dim 80 (32 heads, MHA):
    the prefill kernel over 4 x 256 tokens and the decode kernel over a
    cache of 256 + 16 rows (tiles of 16, split over 4 blocks a row), each
    against its plain version, and both decode kernels bitwise across
    depth x streams; then the prefill kernel at head dim 128 (HD128, GQA
    8); the f32 prefill kernel at both head dims also bitwise across its
    ring's settings (``f32_grid``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.ff_attention import attention, attention_ref
    from repro_torch.kernels.ff_decode_attention import (decode_attention,
                                                         decode_attention_ref)
    cfg = get_config("zamba2_2p7b")
    b, h, d, s = SSM["batch"], cfg.n_heads, cfg.hd, SSM["prompt"]
    gen = torch.Generator(device=dev).manual_seed(10)
    for dtype in (torch.bfloat16, torch.float32):
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        tag = str(dtype).split(".")[1]
        q, k, v = prefill_inputs(torch, dev, dtype, b * h, 1, s, d, gen)
        out = attention(q, k, v)
        e = err(out, attention_ref(q, k, v))
        check(f"ff_attention zamba2 hd={d} {tag} bh={b * h} s={s}",
              e <= tol and out.isfinite().all().item(),
              f"max|kernel-plain|={e:.3e} tol={tol}")
        if dtype == torch.float32:
            check_pipe_bitwise(torch, f"ff_attention zamba2 hd={d} f32",
                               lambda **kw: attention(q, k, v, **kw), out,
                               attention_f32_grid(torch, d))
        pages = -(-(s + SSM["decode_steps"]) // 16)
        skv = pages * 16
        q, pool, tables, lens, kc, vc = decode_inputs(
            torch, dev, dtype, b, h, h, d, 16, pages, b * pages,
            [s + 1, s + 7, s + 16, s + 3], gen)
        out = decode_attention(q, kc, vc, lens, block_kv=16)
        e = err(out, decode_attention_ref(q, kc, vc, lens, block_kv=16))
        check(f"ff_decode_attention zamba2 hd={d} {tag} b={b} h={h} "
              f"skv={skv}", e <= tol and out.isfinite().all().item(),
              f"max|kernel-plain|={e:.3e} tol={tol}")
        check_decode_pipe(torch, f"zamba2 hd={d} {tag}", q, kc, vc, pool,
                          tables, lens, 16, out)
        hh, g = HD128["heads"], HD128["heads"] // HD128["kv_heads"]
        q, k, v = prefill_inputs(torch, dev, dtype, hh, g, HD128["s"],
                                 HD128["d"], gen)
        out = attention(q, k, v, kv_groups=g)
        e = err(out, attention_ref(q, k, v, kv_groups=g))
        check(f"ff_attention hd={HD128['d']} {tag} bh={hh} g={g} "
              f"s={HD128['s']}", e <= tol and out.isfinite().all().item(),
              f"max|kernel-plain|={e:.3e} tol={tol}")
        if dtype == torch.float32:
            check_pipe_bitwise(
                torch, f"ff_attention hd={HD128['d']} f32 g={g}",
                lambda **kw: attention(q, k, v, kv_groups=g, **kw), out,
                attention_f32_grid(torch, HD128["d"]))


def decode_cache(model, cache, s, s_max):
    """A prefill's cache of ``s`` rows ready for decode steps up to
    ``s_max``: the attention and latent caches padded on their sequence
    axis (the hybrid's ``attn[i]`` leaves on axis 1, the stacked
    ``[L, B, S, ...]`` leaves of the dense, VLM and MoE families and the
    encoder-decoder's self-attention cache on axis 2); recurrent states
    and the cross-attention K/V as they are."""
    from repro_torch.launch import serve
    family = model.cfg.family
    if family == "hybrid":
        return serve.pad_cache_to(cache, s, s_max,
                                  {"mamba": None, "attn": 1})
    if family == "encdec":
        return serve.pad_cache_to(cache, s, s_max,
                                  {"self": 2, "cross": None})
    if family in ("dense", "moe", "vlm"):
        return serve.pad_cache_to(cache, s, s_max, 2)
    return cache


def prefill_batch(tokens, extra):
    """The prefill batch of ``tokens`` and ``extra`` (a VLM's
    ``image_embeds``, whisper's ``frames``), and the cache rows it makes
    (a VLM's patches come before its tokens)."""
    batch = {"tokens": tokens, **(extra or {})}
    rows = tokens.shape[1]
    if "image_embeds" in batch:
        rows += batch["image_embeds"].shape[1]
    return batch, rows


def generate(torch, model, params, tokens, n_steps, compiled=True,
             extra=None):
    """A model's path through ``launch/steps.py`` (compiled steps on the
    card unless ``compiled`` is False): one prefill of ``tokens`` [B, S]
    (with the ``extra`` inputs of the batch), then ``n_steps`` greedy
    decode steps from its last logits (the cache padded by ``n_steps``
    rows first). Returns (logits of each step, prefill s, decode s)."""
    from repro_torch.launch import steps
    prefill = steps.make_prefill_step(model, compiled=compiled)
    decode = steps.make_decode_step(model, compiled=compiled)
    b = tokens.shape[0]
    batch, s = prefill_batch(tokens, extra)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cache = decode_cache(model, cache, s, s + n_steps)
    cur = torch.argmax(logits, dim=-1).to(torch.int32)
    lengths = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    out = [logits.clone()]
    for _ in range(n_steps):
        cur, lg, cache = decode(params, {"token": cur, "lengths": lengths},
                                cache)
        out.append(lg.clone())          # the next replay overwrites lg
        lengths = lengths + 1
    torch.cuda.synchronize()
    return out, t1 - t0, time.perf_counter() - t1


def handoff_gap(torch, model, params, tokens):
    """max |prefill(t[:S+1]) - (prefill(t[:S]) then one decode step of
    t[S])| over the logits: the prefill's final state handed to decode."""
    from repro_torch.launch import steps
    prefill = steps.make_prefill_step(model)
    decode = steps.make_decode_step(model)
    b, s1 = tokens.shape
    s = s1 - 1
    whole, _ = prefill(params, {"tokens": tokens})
    _, cache = prefill(params, {"tokens": tokens[:, :s]})
    cache = decode_cache(model, cache, s, s1)
    lengths = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    _, step, _ = decode(params, {"token": tokens[:, s], "lengths": lengths},
                        cache)
    return err(whole, step)


def check_ssm_small(torch, dev):
    """The smoke RWKV6 and Zamba2 models (f32) on the card against the same
    models (plain kernel versions) on the CPU: prefill of two 40-token
    prompts, then 3 greedy decode steps, logits within 1e-3 (the reference
    registry's ff_chunk_scan tolerance) and greedy tokens equal; and the
    handoff gap on the card within 1e-3. RWKV6 also under
    ``scan_impl="xla_tiled"`` (the reference's chunked scan in plain
    PyTorch), within the same tolerance."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.models import build_model
    for arch, scan in [(a, "ff") for a in SSM["archs"]] + [
            ("rwkv6_7b", "xla_tiled")]:
        cfg = smoke_config(arch).replace(scan_impl=scan)
        tag = arch if scan == "ff" else f"{arch} scan_impl={scan}"
        model = build_model(cfg)
        params_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(1, cfg.vocab, (2, 41), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(1))
        got, _, _ = generate(torch, model, tree_to(params_cpu, dev, torch),
                             toks[:, :40].to(dev), 3)
        want, _, _ = generate(torch, model, params_cpu, toks[:, :40], 3)
        got = [g.cpu() for g in got]
        e = max(err(g, w) for g, w in zip(got, want))
        same = all(torch.equal(g.argmax(-1), w.argmax(-1))
                   for g, w in zip(got, want))
        finite = all(g.isfinite().all().item() for g in got)
        check(f"smoke {tag} on card vs cpu (prefill, 3 decode steps)",
              e <= SSM_MODEL_TOL and same and finite,
              f"max|logits diff|={e:.3e} tol={SSM_MODEL_TOL}, greedy equal: "
              f"{same}, finite: {finite}")
        gap = handoff_gap(torch, model, tree_to(params_cpu, dev, torch),
                          toks.to(dev))
        check(f"smoke {tag} handoff gap f32 on card", gap <= HANDOFF_TOL,
              f"max|prefill(S+1) - prefill(S)+decode|={gap:.3e} "
              f"tol={HANDOFF_TOL}")


def run_ssm_models(torch, dev):
    """Full-width rwkv6-7b, then zamba2-2.7b on the card (random f32 weights
    from seed 0, cast once to bf16 where only bf16 is read, bf16
    compute): a warm-up prefill, then with every launch count set to 0
    one prefill of SSM's 4 x 256-token prompts and 16 greedy decode steps
    through ``launch/steps.py``'s compiled steps. Requires finite
    logits, exactly one ff_chunk_scan launch per layer in the prefill, and
    for Zamba2 attention launches in prefill and decode; prints the
    prefill ms, decode ms per step, tokens/s, peak memory, the bf16
    handoff gap (printed, required finite), a profile of the prefill (the
    scan's share of its device time) and of the decode step, each
    compiled and eager in turn. Returns the chunk scan's launches per
    model."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    b, s, n_steps = SSM["batch"], SSM["prompt"], SSM["decode_steps"]
    wr = wrappers()
    scan_launches = {}
    for arch in SSM["archs"]:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init_cast(torch.Generator(device=dev).manual_seed(0),
                                 dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(x.numel() for _, x in L.tree_leaves(params))
        toks = torch.randint(1, cfg.vocab, (b, s + 1), dtype=torch.int32,
                             device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(2))
        generate(torch, model, params, toks[:, :s], 1)       # warm-up
        for w in wr.values():
            w.launches = 0
        logits, prefill_s, decode_s = generate(torch, model, params,
                                                   toks[:, :s], n_steps)
        launches = {name: w.launches for name, w in wr.items()
                    if w.launches}
        gap = handoff_gap(torch, model, params, toks)
        pre = {mode: profile_ssm_prefill(torch, model, params, toks[:, :s],
                                         compiled=mode == "compiled")
               for mode in ("compiled", "eager")}
        prof = profile_ssm_decode(torch, model, params, toks[:, :s])
        finite = all(lg.isfinite().all().item() for lg in logits)
        summary = dict(
            arch=arch, params=n_params, init_s=init_s, batch=b, prompt=s,
            decode_steps=n_steps, prefill_ms=prefill_s * 1e3,
            decode_ms_per_step=decode_s * 1e3 / n_steps,
            decode_tokens_per_s=b * n_steps / decode_s,
            prefill_tokens_per_s=b * s / prefill_s,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            handoff_gap_bf16=gap, launches=launches, prefill_profile=pre,
            decode_profile=prof)
        print(f"model[{arch}] " + json.dumps(summary), flush=True)
        check(f"model[{arch}] logits finite and of shape "
              f"[{b}, {cfg.padded_vocab}]",
              finite and all(lg.shape == (b, cfg.padded_vocab)
                             for lg in logits), f"finite: {finite}")
        got = launches.get("ff_chunk_scan", 0)
        check(f"model[{arch}] ff_chunk_scan one launch per layer",
              got == cfg.n_layers,
              f"{got} launches in one prefill, {cfg.n_layers} layers")
        if cfg.family == "hybrid":
            for name in ("ff_attention", "ff_decode_attention"):
                check(f"model[{arch}] {name} launched",
                      launches.get(name, 0) > 0,
                      f"{launches.get(name, 0)} launches")
        check(f"model[{arch}] handoff gap bf16 finite", math.isfinite(gap),
              f"{gap:.3e}")
        scan_launches[arch] = got
        del params, model, logits
    torch.cuda.empty_cache()
    return scan_launches


def profile_ssm_prefill(torch, model, params, tokens, compiled=True,
                        extra=None):
    """Where a full-width prefill's time goes: its wall ms (host clock
    around one synchronised prefill, after one unclocked), then one
    profiled prefill: the device's busy ms (kernel and copy times from
    torch.profiler), device kernels, host launch calls, and the chunk
    scan's kernels' device ms and launches, with the scan's share of the
    busy time and of the wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps
    prefill = steps.make_prefill_step(model, compiled=compiled)
    batch = prefill_batch(tokens, extra)[0]
    prefill(params, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prefill(params, batch)
        torch.cuda.synchronize()
    p = device_profile(prof, 1)
    scan = sum(t for n, t in p["by_name"].items() if "scan_kernel" in n)
    busy = p["device_ms"]
    return {"wall_ms": wall, "device_ms": busy,
            "device_busy_share": busy / wall if busy else None,
            "device_kernels": p["device_kernels"],
            "host_launch_calls": p["host_launch_calls"],
            "host_copy_calls": p["host_copy_calls"],
            "scan_device_ms": scan,
            "scan_launches": sum(c for n, c in p["count"].items()
                                 if "scan_kernel" in n),
            "scan_share_of_device": scan / busy if busy else None,
            "scan_share_of_wall": scan / wall}


def profile_ssm_decode(torch, model, params, tokens, n_steps=8, rounds=3,
                       extra=None):
    """Where a full-width decode step's time goes, compiled and eager in
    turn (``profile_steps``), each from its own prefill of ``tokens`` and
    ``extra`` (the attention and latent caches padded for every step)."""
    from repro_torch.launch import steps
    b = tokens.shape[0]
    batch, s = prefill_batch(tokens, extra)

    def make_step(compiled):
        prefill = steps.make_prefill_step(model, compiled=compiled)
        decode = steps.make_decode_step(model, compiled=compiled)
        logits, cache = prefill(params, batch)
        cache = decode_cache(model, cache, s,
                             s + (rounds + 2) * n_steps + 2)
        state = {"cur": torch.argmax(logits, dim=-1).to(torch.int32),
                 "len": torch.full((b,), s, dtype=torch.int32,
                                   device=tokens.device), "cache": cache}

        def step():
            state["cur"], _, state["cache"] = decode(
                params, {"token": state["cur"], "lengths": state["len"]},
                state["cache"])
            state["cur"].cpu()               # as a scheduler reads it
            state["len"] = state["len"] + 1
        return step

    out = profile_steps(torch, {"compiled": make_step(True),
                                "eager": make_step(False)}, n_steps, rounds)
    for p in out.values():
        for key in ("by_name", "count"):
            del p[key]
    return out


def time_scan_kernel(torch, dev, scan_launches):
    """ff_chunk_scan at both models' prefill shapes with their stream types
    (contiguous operands: the kernel's own time, no copy), at chunk 64 (the
    models' own) and 256: cold and warm device ms, call_ms, the plain
    version's ms, the ring body's blocks a row and blocks an SM, and the
    bound: the larger of the bytes (each operand read once in its type,
    the output written once) over 3.35 TB/s and the reference cost model's
    operations (``ops.py:chunk_scan_cost``) over 989 TFLOP/s. No single
    PyTorch call computes this scan, so there is no library time."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ff_chunk_scan import chunk_scan, chunk_scan_plain
    from repro_torch.kernels.ff_chunk_scan import ops as SO
    gen = torch.Generator(device=dev).manual_seed(11)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    occupancy = _build.load("ff_chunk_scan").ff_chunk_scan_ring_occupancy
    occupancy.argtypes = [ctypes.c_int] * 4
    s = SSM["prompt"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for (label, bh, n, p, exclusive), arch, chunk in (
            (shape, arch, chunk)
            for shape, arch in zip(scan_shapes(), SSM["archs"])
            for chunk in (64, 256)):
        heads = 1 if exclusive else bh // SSM["batch"]
        args = [x.contiguous() if x is not None else None
                for x in scan_operands(torch, dev, gen, bh, s, n, p,
                                       exclusive, torch.bfloat16, True,
                                       heads)]
        kw = dict(inclusive=not exclusive, chunk=chunk)
        out = chunk_scan(*args, **kw)
        nbytes = sum(x.numel() * x.element_size() for x in args
                     if x is not None) + out.numel() * out.element_size()
        per_chunk = 2.0 * chunk * n * p * 2 + chunk * chunk * (n + p)
        ops = bh * (s // chunk) * per_chunk
        types = "/".join(str(x.dtype)[6:] if x is not None else "-"
                         for x in args)
        plan = SO._plan(bh, s, n, p, chunk, sms)
        print(f"f. timing ff_chunk_scan {label} chunk {chunk}", flush=True)
        # the same call with P cut into two slices of 32 columns (each
        # block repeats its row's cumsum and exponents), against _plan's
        plan_of = SO._plan
        SO._plan = lambda *a: plan_of(*a)._replace(slices=2,
                                                   cols=plan_of(*a).cols // 2)
        try:
            two_slices_ms = time_ms(torch, lambda: chunk_scan(*args, **kw),
                                    50, flush)
        finally:
            SO._plan = plan_of
        rows.append(dict(
            shape=(f"{label} prefill: q/k/log_w[{bh},{s},{n}] v[{bh},{s},"
                   f"{p}]{' u[%d,%d]' % (bh, n) if exclusive else ''} "
                   f"({types}), {'exclusive+u' if exclusive else 'inclusive'}"
                   f", chunk {chunk}, subtile 16"),
            launches_on_path=scan_launches.get(arch) if chunk == 64 else 0,
            blocks=plan.blocks, slices=plan.slices,
            blocks_per_sm=occupancy(n, int(args[3].dtype == torch.bfloat16),
                                    plan.cols, CONSTANTS["depth"]),
            ms_two_slices=two_slices_ms,
            ms=time_ms(torch, lambda: chunk_scan(*args, **kw), 100, flush),
            ms_hot=time_ms(torch, lambda: chunk_scan(*args, **kw), 100),
            call_ms=call_ms(torch, lambda: chunk_scan(*args, **kw), 50),
            plain_ms=time_ms(torch, lambda: chunk_scan_plain(*args, **kw),
                             10, flush),
            library_ms=None,
            library="none: no single PyTorch call computes this scan",
            bound=bound(nbytes, ops, "bfloat16")))
        del args, out
    rows.extend(time_scan_f32(torch, dev, gen, flush))
    first, *more = rows
    first["more"] = [split_bound(r) for r in more]
    return {"ff_chunk_scan": first}


def scan_passes(torch, args, kw):
    """Where a block of the f32 ring body spends its cycles, at the planned
    ring of the call ``chunk_scan(*args, **kw)``: one more launch with the
    kernel's clock counters on (thread 0's clock64 deltas a block: waiting
    for a word, passes AB, C1 and C2), as shares of the block's cycles
    averaged over the blocks, and cycles a word."""
    from repro_torch.kernels.ff_chunk_scan import chunk_scan
    from repro_torch.kernels.ff_chunk_scan import ops as SO
    seen, restore = spy_resolutions()
    try:
        chunk_scan(*args, **kw)
    finally:
        restore()
    choice = seen[-1][3]
    q, k, v, lw, u = args
    chunk = choice.tile_kwargs.get("chunk", kw["chunk"])
    plan = SO._f32_plan(q.shape[0], v.shape[2])
    clocks = torch.zeros(plan.blocks, 4, dtype=torch.int64, device=q.device)
    SO._launch(q, k, v, lw, u, chunk, 16, kw["inclusive"], choice.depth,
               choice.streams, clocks=clocks)
    torch.cuda.synchronize()
    c = clocks.double()
    share = (c / c.sum(1, keepdim=True)).mean(0).tolist()
    words = -(-q.shape[1] // 16)
    return {"depth": choice.depth, "streams": choice.streams,
            "share": dict(zip(("wait", "AB", "C1", "C2"), share)),
            "cycles_per_word": c.sum(1).mean().item() / words}


def time_scan_f32(torch, dev, gen, flush):
    """The f32 scan (the f32 ring body) at N = P = 256, chunk 256, S = 256,
    16 rows, exclusive with u (the timing shape of PERF.md's row 9 f32),
    and at both models' prefill shapes in f32 (chunk 64): no model's path
    runs it (their scans are bf16 on the tensor-core body). Each row names
    the body, its plan and its planned ring, the blocks an SM holds there,
    and where a block's cycles go (``scan_passes``). Bound: the f32 bytes
    over 3.35 TB/s against the scan's operations, 4 bh S N P (a row's
    carried-state product and state update, 2 N P each; the body takes no
    chunk-squared term), over the 67 TFLOP/s of f32 outside the tensor
    cores."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ff_chunk_scan import chunk_scan, chunk_scan_plain
    from repro_torch.kernels.ff_chunk_scan import ops as SO
    occupancy = _build.load("ff_chunk_scan").ff_chunk_scan_f32_ring_occupancy
    occupancy.argtypes = [ctypes.c_int] * 4
    rows = []
    cases = [("N=P=256", 16, 256, 256, True, 256)] + [
        (f"{label} prefill", bh, n, p, exclusive, 64)
        for label, bh, n, p, exclusive in scan_shapes()]
    for label, bh, n, p, exclusive, chunk in cases:
        s = 256
        args = scan_operands(torch, dev, gen, bh, s, n, p, exclusive,
                             torch.float32)
        kw = dict(inclusive=not exclusive, chunk=chunk)
        print(f"f. timing ff_chunk_scan f32 {label} chunk {chunk}",
              flush=True)
        out = chunk_scan(*args, **kw)
        nbytes = sum(x.numel() * x.element_size() for x in args
                     if x is not None) + out.numel() * out.element_size()
        ops = 4.0 * bh * s * n * p   # the state's products a row
        plan = SO._f32_plan(bh, p)
        passes = scan_passes(torch, args, kw)
        reps = 20 if n == 256 else 100
        rows.append(dict(
            shape=(f"{label}: q/k/log_w[{bh},{s},{n}] v[{bh},{s},{p}]"
                   f"{' u[%d,%d]' % (bh, n) if exclusive else ''} float32, "
                   f"{'exclusive+u' if exclusive else 'inclusive'}, chunk "
                   f"{chunk} (f32 ring body: {plan.slices} slices of "
                   f"{plan.cols} columns, {plan.blocks} blocks, planned "
                   f"depth {passes['depth']} streams {passes['streams']})"),
            launches_on_path=0,
            blocks=plan.blocks, slices=plan.slices,
            blocks_per_sm=occupancy(n, 0, plan.cols, passes["depth"]),
            passes=passes,
            ms=time_ms(torch, lambda: chunk_scan(*args, **kw), reps, flush),
            ms_hot=time_ms(torch, lambda: chunk_scan(*args, **kw), reps),
            call_ms=call_ms(torch, lambda: chunk_scan(*args, **kw), 10),
            plain_ms=time_ms(torch, lambda: chunk_scan_plain(*args, **kw), 3,
                             flush),
            library_ms=None,
            library="none: no single PyTorch call computes this scan",
            bound=bound(nbytes, ops, "float32")))
        del args, out
    return rows


def sdpa_backend(torch, q4, k4, v4, **kw):
    """The first SDPA backend, in PyTorch's own order of preference, that
    takes these operands when it is the only one allowed: the one the
    default call runs."""
    import warnings
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for name in ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")   # each refusal's reasons
                F.scaled_dot_product_attention(q4, k4, v4, **kw)
            torch.cuda.synchronize()
            return name
        except RuntimeError:
            continue
    return "none"


def time_f32_bodies(torch, dev, shapes, scan=True):
    """Every float32 body at the shapes of its bf16 row in PERF.md (rows 1,
    4-6, 8 and its mixed f32 x bf16 pair, 8a, 8b, 9): device ms L2 cold
    and warm, the plain version's ms, the PyTorch call computing the same
    function in f32 (torch.matmul with TF32 off; SDPA, naming the backend
    it ran; for rows 4-6 the products alone) and the bound: f32 bytes over
    3.35 TB/s against the operations over 67 TFLOP/s; row 8b also the
    product on rows gathered beforehand (``plain_a_ms``), row 6 its three
    staged launches (``staged_ms``). One ``f32_bodies`` line. The
    wrappers run at their planned ring. ``scan=False`` leaves out row 9
    (time_scan_kernel times it in a full run)."""
    import torch.nn.functional as F
    from repro_torch.kernels.ff_attention import (attention, attention_proj,
                                                  attention_proj_ref,
                                                  attention_ref)
    from repro_torch.kernels.ff_layer import (ff_layer_matmul,
                                              ff_layer_matmul_ref,
                                              ff_layer_mlp_tail,
                                              ff_layer_mlp_tail_ref,
                                              ff_layer_swiglu,
                                              ff_layer_swiglu_ref,
                                              mlp_tail_staged)
    from repro_torch.kernels.ff_matmul import (dispatch_matmul,
                                               dispatch_matmul_ref, matmul,
                                               matmul_ref)
    gen = torch.Generator(device=dev).manual_seed(12)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    f32 = torch.float32
    rows = {}

    def row(name, shape, kernel, plain, library, nbytes, ops, n,
            library_note=None):
        print(f"f. timing f32 {name} {shape}", flush=True)
        r = dict(shape=shape, ms=time_ms(torch, kernel, n, flush),
                 ms_hot=time_ms(torch, kernel, n),
                 plain_ms=time_ms(torch, plain, max(n // 10, 3), flush),
                 library_ms=(time_ms(torch, library, n, flush)
                             if library is not None else None),
                 bound=bound(nbytes, ops, "float32"))
        if library_note:
            r["library"] = library_note
        rows.setdefault(name, []).append(split_bound(r))

    for key in ("prefill", "prefill_256"):
        bh, groups, s, d = shapes[key]
        q, k, v = prefill_inputs(torch, dev, f32, bh, groups, s, d, gen)
        b, h = SERVE["slots"], bh // SERVE["slots"]
        q4, k4, v4 = (q.view(b, h, s, d), k.view(b, h // groups, s, d),
                      v.view(b, h // groups, s, d))
        kw = dict(is_causal=True, **gqa(groups))
        row("ff_attention",
            f"q[{bh},{s},{d}] kv[{bh // groups},{s},{d}] causal f32",
            lambda: attention(q, k, v, kv_groups=groups),
            lambda: attention_ref(q, k, v, kv_groups=groups),
            lambda: F.scaled_dot_product_attention(q4, k4, v4, **kw),
            (2 * q.numel() + k.numel() + v.numel()) * 4,
            4 * d * bh * s * (s + 1) / 2, 200,
            f"SDPA ({sdpa_backend(torch, q4, k4, v4, **kw)})")
    for lbl, m, k, n in LIB["matmul"]:
        reps = 10 if m * n * k > 2 ** 34 else 100
        for tb in (f32, torch.bfloat16):
            a, b = matmul_operands(torch, dev, gen, m, k, n, f32, tb)
            tag = "f32" if tb == f32 else "f32 x bf16"
            row("ff_matmul", f"a[{m},{k}] @ b[{k},{n}] {tag} ({lbl})",
                lambda a=a, b=b: matmul(a, b),
                lambda a=a, b=b: matmul_ref(a, b),
                (lambda a=a, b=b: torch.matmul(a, b)) if tb == f32 else None,
                m * k * 4 + k * n * b.element_size() + m * n * 4,
                2 * m * n * k, reps,
                None if tb == f32 else "none: torch.matmul wants one type")
            del a, b
    bh, s, d, d_out = LIB["attention_proj"]
    q, k, v, w = attn_proj_operands(torch, dev, gen, bh, s, d, d_out, f32)
    b_, h_ = SERVE["slots"], bh // SERVE["slots"]
    q4, k4, v4 = (x.view(b_, h_, s, d) for x in (q, k, v))
    row("ff_attention_proj", f"q/k/v[{bh},{s},{d}] causal, w[{d},{d_out}] f32",
        lambda: attention_proj(q, k, v, w),
        lambda: attention_proj_ref(q, k, v, w),
        lambda: torch.matmul(F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True).reshape(bh * s, d), w),
        (3 * bh * s * d + d * d_out + bh * s * d_out) * 4,
        4 * d * bh * s * (s + 1) / 2 + 2 * bh * s * d * d_out, 100,
        "SDPA then torch.matmul")
    t, d, n, f, t_out = LIB["moe"]
    idx, tokens, w1, _ = moe_operands(torch, dev, gen, t, d, n, f, t_out, f32)
    row("ff_dispatch_matmul",
        f"tokens[{t},{d}], idx[{n}], w1[{d},{f}] f32 (gathered A)",
        lambda: dispatch_matmul(tokens, idx, w1),
        lambda: dispatch_matmul_ref(tokens, idx, w1),
        lambda: torch.matmul(torch.index_select(tokens, 0, idx), w1),
        (uniq(idx) * d + d * f + n * f) * 4 + n * 4, 2 * n * d * f, 100,
        "index_select then torch.matmul")
    # the same product on the rows gathered beforehand (A by TMA)
    gathered = tokens[idx.long()].contiguous()
    rows["ff_dispatch_matmul"][-1]["plain_a_ms"] = time_ms(
        torch, lambda: matmul(gathered, w1), 100, flush)
    for arch in (SERVE["arch"], "qwen2_72b"):
        lay = main_path_shapes(torch, arch)["layer"]
        m, d, hq, f = lay["b"], lay["d"], lay["hq"], lay["f"]
        t = layer_inputs(torch, dev, f32, m, lay, gen)
        q_kw = dict(norm_weight=t["nw1"], bias=t["bq"],
                    rope_theta=lay["theta"], head_dim=lay["hd"],
                    positions=torch.tensor(lay["positions"], device=dev,
                                           dtype=torch.int32))
        note = "products alone (torch.matmul), not the fused function"
        row("ff_layer_matmul", f"{arch} a[{m},{d}] @ wq[{d},{hq}], RMSNorm, "
            f"q bias, RoPE f32",
            lambda: ff_layer_matmul(t["x"], t["wq"], **q_kw),
            lambda: ff_layer_matmul_ref(t["x"], t["wq"], **q_kw),
            lambda: torch.matmul(t["x"], t["wq"]),
            (m * d + d * hq + hq + m * hq) * 4 + d * 4 + m * 4,
            2 * m * d * hq, 100, note)
        row("ff_layer_swiglu", f"{arch} x[{m},{d}] @ wg, wu[{d},{f}], "
            f"RMSNorm f32",
            lambda: ff_layer_swiglu(t["x"], t["wg"], t["wu"],
                                    norm_weight=t["nw2"]),
            lambda: ff_layer_swiglu_ref(t["x"], t["wg"], t["wu"],
                                        norm_weight=t["nw2"]),
            lambda: torch.matmul(t["x"], t["wi"]),
            (m * d + 2 * d * f + m * f) * 4 + d * 4, 4 * m * d * f, 50, note)
        row("ff_layer_mlp_tail", f"{arch} a[{m},{hq}] @ wo + x; RMSNorm, "
            f"SwiGLU [{d},{f}]; @ wo2 + h f32",
            lambda: ff_layer_mlp_tail(*tail_args(t)),
            lambda: ff_layer_mlp_tail_ref(*tail_args(t)),
            lambda: (torch.matmul(t["a"], t["wo"]),
                     torch.matmul(t["x"], t["wi"]),
                     torch.matmul(t["act"], t["wo2"])),
            (m * hq + hq * d + 2 * m * d + 2 * d * f + f * d) * 4 + d * 4,
            2 * m * (hq * d + 2 * d * f + f * d), 50, note)
        # beside it its three staged launches (ROADMAP B.2: the bf16 tail
        # lost to them at qwen2-72b's widths)
        rows["ff_layer_mlp_tail"][-1]["staged_ms"] = time_ms(
            torch, lambda: mlp_tail_staged(*tail_args(t)), 50, flush)
        del t
    if scan:
        rows["ff_chunk_scan"] = [split_bound(r) for r in
                                 time_scan_f32(torch, dev, gen, flush)]
    print("f32_bodies " + json.dumps(rows), flush=True)
    return rows


# ---------------------------------------------------------------------------
# b, e (slice 12). the MoE family: grok-1's attention heads, the smoke MoE
# models, full-width deepseek-v2-lite
# ---------------------------------------------------------------------------


def check_heads(torch, dev, arch, name):
    """Prefill and decode attention at ``arch``'s heads at its default
    serve run's shapes (4 slots, its prefill bucket, page 16, the lengths
    of its first lockstep batch halfway through decode), against their
    plain versions; paged == contiguous bit for bit, and both bitwise
    across depth x streams (prefill attention too, in bf16)."""
    from repro_torch.kernels.ff_attention import attention, attention_ref
    from repro_torch.kernels.ff_decode_attention import (decode_attention,
                                                         decode_attention_ref)
    from repro_torch.runtime.paged_kv import (paged_decode_attention,
                                              paged_decode_attention_ref)
    shapes = main_path_shapes(torch, arch)
    bh, g, p_max, d = shapes["prefill"]
    dec = shapes["decode"]
    h, kvh, page, lengths = dec["h"], dec["kvh"], dec["page"], \
        dec["lengths"]
    slots = dec["b"]
    gen = torch.Generator(device=dev).manual_seed(12)
    for dtype in (torch.bfloat16, torch.float32):
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        tag = f"{name} heads {h}/{kvh} hd={d} {str(dtype).split('.')[1]}"
        q, k, v = prefill_inputs(torch, dev, dtype, bh, g, p_max, d, gen)
        out = attention(q, k, v, kv_groups=g)
        e = err(out, attention_ref(q, k, v, kv_groups=g))
        check(f"ff_attention {tag} bh={bh} s={p_max}",
              e <= tol and out.isfinite().all().item(),
              f"max|kernel-plain|={e:.3e} tol={tol}")
        if dtype == torch.bfloat16:
            check_pipe_bitwise(
                torch, f"ff_attention {tag} bh={bh} s={p_max}",
                lambda **kw: attention(q, k, v, kv_groups=g, **kw), out)
        q, pool, tables, lens, kc, vc = decode_inputs(
            torch, dev, dtype, slots, h, kvh, d, page, dec["n_pages"],
            dec["n_blocks"], lengths, gen)
        out_c = decode_attention(q, kc, vc, lens, block_kv=page)
        out_p = paged_decode_attention(q, pool, tables, lens)
        e_c = err(out_c, decode_attention_ref(q, kc, vc, lens,
                                              block_kv=page))
        e_p = err(out_p, paged_decode_attention_ref(q, pool, tables, lens))
        check(f"ff_decode_attention {tag} lengths={lengths}", e_c <= tol,
              f"max|kernel-plain|={e_c:.3e} tol={tol}")
        check(f"ff_paged_decode_attention {tag} page={page}", e_p <= tol,
              f"max|kernel-plain|={e_p:.3e} tol={tol}")
        check(f"paged == contiguous bitwise {tag}", torch.equal(out_c, out_p),
              f"max diff {err(out_c, out_p)}")
        check_decode_pipe(torch, tag, q, kc, vc, pool, tables, lens, page,
                          out_c)


def record_routing(model, calls):
    """Make ``model``'s MoE FFN append each call's router probabilities
    (on the CPU) to ``calls``: the stack's FFN hook, wrapped. Eager steps
    only (a replayed graph runs no Python)."""
    from repro_torch.models import moe
    inner = model.stack._ffn_apply

    def ffn_apply(cfg, p, x):
        calls.append(moe.router_gates(p, x.reshape(-1, x.shape[-1])).cpu())
        return inner(cfg, p, x)
    model.stack._ffn_apply = ffn_apply


def routing_flips(torch, got, want, k):
    """(router call, token, the CPU's gate margin between its k-th and
    (k+1)-th expert) for each token whose top-k experts differ."""
    flips = []
    for i, (a, b) in enumerate(zip(got, want)):
        ia = torch.topk(a, k).indices
        ib = torch.topk(b, k).indices
        for t in torch.nonzero((ia != ib).any(-1)).flatten().tolist():
            top = torch.sort(b[t], descending=True).values
            flips.append((i, t, (top[k - 1] - top[k]).item()))
    return flips


def check_moe_small(torch, dev):
    """The smoke grok-1 and deepseek-v2-lite models (f32) on the card
    against the same models on the CPU: prefill of two 24-token prompts
    and 3 greedy decode steps through the compiled steps, logits within
    MODEL_TOL and greedy tokens equal; then the same run eagerly with each
    MoE layer's routing recorded on both sides: the top-k experts of
    every token of every layer and step equal (a flip is reported with
    its gate margin)."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.models import build_model
    for arch in MOE_ARCHS:
        cfg = smoke_config(arch)
        model = build_model(cfg)
        params_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
        params = tree_to(params_cpu, dev, torch)
        toks = torch.randint(1, cfg.vocab, (2, 24), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(3))
        got = [g.cpu() for g in generate(torch, model, params, toks.to(dev),
                                         3)[0]]
        want = generate(torch, model, params_cpu, toks, 3)[0]
        e = max(err(g, w) for g, w in zip(got, want))
        same = all(torch.equal(g.argmax(-1), w.argmax(-1))
                   for g, w in zip(got, want))
        finite = all(g.isfinite().all().item() for g in got)
        check(f"smoke {arch} on card vs cpu (prefill, 3 decode steps)",
              e <= MODEL_TOL and same and finite,
              f"max|logits diff|={e:.3e} tol={MODEL_TOL}, greedy equal: "
              f"{same}, finite: {finite}")
        calls = {}
        for side, prm, tk in (("card", params, toks.to(dev)),
                              ("cpu", params_cpu, toks)):
            m = build_model(cfg)
            calls[side] = []
            record_routing(m, calls[side])
            generate(torch, m, prm, tk, 3, compiled=False)
        flips = routing_flips(torch, calls["card"], calls["cpu"], cfg.top_k)
        n = len(calls["cpu"])
        check(f"smoke {arch} routing on card == cpu",
              not flips and n == len(calls["card"]) == 4 * cfg.n_layers,
              f"{n} router calls ({cfg.n_layers} layers x prefill + 3 "
              f"steps), top-{cfg.top_k} of {cfg.n_experts}; flips (call, "
              f"token, gate margin): {flips[:8]}")


def check_new_models_small(torch, dev):
    """The smoke llama3.2-1b, starcoder2-15b, qwen2-72b, internvl2-1b
    (with and without patch embeddings) and whisper-tiny (with frames)
    models (f32) on the card against the same models on the CPU: prefill
    of two 24-token prompts and 3 greedy decode steps through the
    compiled steps, logits within MODEL_TOL and greedy tokens equal."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.models import build_model
    for arch, with_extra in NEW_SMALL:
        cfg = smoke_config(arch)
        model = build_model(cfg)
        params_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
        params = tree_to(params_cpu, dev, torch)
        gen = torch.Generator().manual_seed(3)
        toks = torch.randint(1, cfg.vocab, (2, 24), dtype=torch.int32,
                             generator=gen)
        extra, tag = {}, ""
        if with_extra and cfg.family == "vlm":
            extra["image_embeds"] = torch.randn(2, cfg.n_patches,
                                                cfg.d_model, generator=gen)
            tag = f", {cfg.n_patches} patch embeddings"
        if cfg.family == "encdec":
            extra["frames"] = torch.randn(2, cfg.n_frames, cfg.d_model,
                                          generator=gen)
            tag = f", {cfg.n_frames} frames"
        got = [g.cpu() for g in generate(
            torch, model, params, toks.to(dev), 3,
            extra={k: v.to(dev) for k, v in extra.items()})[0]]
        want = generate(torch, model, params_cpu, toks, 3, extra=extra)[0]
        e = max(err(g, w) for g, w in zip(got, want))
        same = all(torch.equal(g.argmax(-1), w.argmax(-1))
                   for g, w in zip(got, want))
        finite = all(g.isfinite().all().item() for g in got)
        check(f"smoke {arch} on card vs cpu (prefill{tag}, 3 decode "
              f"steps)", e <= MODEL_TOL and same and finite,
              f"max|logits diff|={e:.3e} tol={MODEL_TOL}, greedy equal: "
              f"{same}, finite: {finite}")


def decode_weight_bytes(cfg, leaves):
    """The weight bytes a decode step reads (each once), from (path,
    tensor) leaves: every leaf but the embedding, which is gathered (a
    tied one is read whole as the unembedding), whisper's learned
    positions (a row a step) and its encoder (run at prefill only)."""
    skip = {"dec_pos", "enc_layers", "enc_norm"}
    return sum(x.numel() * x.element_size() for path, x in leaves
               if (path[0] != "embed" or cfg.tie_embeddings)
               and not skip & set(path))


def run_steps_model(torch, dev, spec, required, no_kernel=None):
    """A full-width model (bf16, drawn and cast leaf by leaf from seed 0)
    through ``launch/steps.py``: a warm-up, then with every launch count
    set to 0 one prefill of ``spec``'s prompts (with a VLM's random patch
    embeddings or whisper's random frames, full size) and its greedy
    decode steps compiled, then the same eagerly. Requires finite logits
    of the right shape, every compiled step's logits equal to the eager
    step's bit for bit, and the kernels in ``required`` launched, or, with
    ``no_kernel`` (the reason), no kernel of the port launched. Prints a
    ``model[...]`` line: prefill and decode ms, compiled and eager, a
    profile of each (busy share, device kernels), peak memory, and the
    bytes of weights a decode step reads (every expert's, for the MoE:
    the reference runs all experts over the capacity buffer). Returns the
    launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    arch, b, s, n_steps = (spec["arch"], spec["batch"], spec["prompt"],
                           spec["decode_steps"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_cast(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    leaves = list(L.tree_leaves(params))
    n_params = sum(x.numel() for _, x in leaves)
    weight_bytes = decode_weight_bytes(cfg, leaves)
    expert_bytes = sum(x.numel() * x.element_size() for path, x in leaves
                       if path[-1] in ("w1", "w2"))
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(1, cfg.vocab, (b, s), dtype=torch.int32,
                         device=dev, generator=gen)
    extra = {}
    if cfg.family == "vlm":
        extra["image_embeds"] = torch.randn(
            b, cfg.n_patches, cfg.d_model, generator=gen,
            device=dev).to(cfg.cdtype)
    if cfg.family == "encdec":
        extra["frames"] = torch.randn(b, cfg.n_frames, cfg.d_model,
                                      generator=gen, device=dev
                                      ).to(cfg.cdtype)
    # warm-up: the captures
    generate(torch, model, params, toks, n_steps, extra=extra)
    wr = wrappers()
    for w in wr.values():
        w.launches = 0
    compiled, prefill_s, decode_s = generate(torch, model, params, toks,
                                             n_steps, extra=extra)
    launches = {name: w.launches for name, w in wr.items() if w.launches}
    eager, prefill_e, decode_e = generate(torch, model, params, toks,
                                          n_steps, compiled=False,
                                          extra=extra)
    pre = {}
    for mode in ("compiled", "eager"):
        pre[mode] = profile_ssm_prefill(torch, model, params, toks,
                                        compiled=mode == "compiled",
                                        extra=extra)
        for key in [k for k in pre[mode] if k.startswith("scan_")]:
            del pre[mode][key]
    prof = profile_ssm_decode(torch, model, params, toks, extra=extra)
    summary = dict(
        arch=arch, params=n_params, init_s=init_s,
        init_peak_memory_gib=init_peak, batch=b, prompt=s,
        extra_inputs={k: list(v.shape) for k, v in extra.items()},
        decode_steps=n_steps, prefill_ms=prefill_s * 1e3,
        prefill_ms_eager=prefill_e * 1e3,
        decode_ms_per_step=decode_s * 1e3 / n_steps,
        decode_ms_per_step_eager=decode_e * 1e3 / n_steps,
        decode_tokens_per_s=b * n_steps / decode_s,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        decode_weight_bytes_read=weight_bytes,
        decode_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        launches=launches,
        prefill_profile=pre, decode_profile=prof)
    if expert_bytes:
        summary["decode_expert_bytes_read"] = expert_bytes
    print(f"model[{arch}] " + json.dumps(summary), flush=True)
    finite = all(lg.isfinite().all().item() for lg in compiled)
    check(f"model[{arch}] logits finite and of shape "
          f"[{b}, {cfg.padded_vocab}]",
          finite and all(lg.shape == (b, cfg.padded_vocab)
                         for lg in compiled), f"finite: {finite}")
    same = [torch.equal(c, e) for c, e in zip(compiled, eager)]
    check(f"model[{arch}] every compiled step == eager bitwise", all(same),
          f"prefill and {n_steps} decode steps' logits: {same}")
    if no_kernel is not None:
        check(f"model[{arch}] launches no kernel of the port ({no_kernel})",
              not launches, f"launches {launches}")
    for name in required:
        check(f"model[{arch}] {name} launched", launches.get(name, 0) > 0,
              f"{launches.get(name, 0)} launches")
    del params, model, compiled, eager
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# c-e. the main path
# ---------------------------------------------------------------------------


def run_serve(torch, label, required, **overrides):
    """One serve run with every launch count set to 0 just before it and
    read just after; ``required`` names the kernels the run must launch.
    Paged == dense bit for bit is required of the per-op runs; under the
    layer graph the difference is printed and must be finite. Every step
    of a run on the card is compiled: the run must have captured prefill
    and decode graphs (a capture that fails raises)."""
    from repro_torch.launch import serve
    wr = wrappers()
    for w in wr.values():
        w.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = serve.serve_bench(Namespace(**{**SERVE, **overrides}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wr.items()}
    summary = {k: result[k] for k in ("arch", "n_layers", "impl",
                                      "prompt_len", "bitwise_max_abs_diff",
                                      "token_count_parity",
                                      "compiled_graphs")}
    for name in ("lockstep", "paged"):
        summary[name] = {k: result[name][k] for k in (
            "tokens", "tokens_per_s", "p50_ms", "p99_ms", "decode_steps",
            "decode_s", "prefill_s", "kv_util")}
    summary.update(wall_s=wall, launches=launches,
                   peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"serve[{label}] " + json.dumps(summary), flush=True)
    graphs = result["compiled_graphs"]
    check(f"serve[{label}] every step compiled",
          graphs.get("prefill", 0) > 0 and graphs.get("decode", 0) > 0,
          f"CUDA graphs captured: {graphs}")
    diff = result["bitwise_max_abs_diff"]
    if overrides.get("layer_graph"):
        check(f"serve[{label}] layer graph vs paged difference finite",
              math.isfinite(diff), f"bitwise_max_abs_diff={diff}")
    else:
        check(f"serve[{label}] paged == dense bitwise", diff == 0.0,
              f"bitwise_max_abs_diff={diff}")
    check(f"serve[{label}] token parity", result["token_count_parity"]
          and result["lockstep"]["tokens"] > 0,
          f"lockstep {result['lockstep']['tokens']} vs paged "
          f"{result['paged']['tokens']} tokens")
    for name in required:
        check(f"serve[{label}] {name} launched", launches[name] > 0,
              f"{launches[name]} launches")
    return launches


def run_new_serves(torch, dev):
    """The dense configs and the VLM served at full width (NEW_SERVE: the
    serve defaults, qwen2-72b cut in depth, llama3.2-1b once more under
    ``--layer-graph``), each with ``run_serve``'s gates; after each
    per-op run, its steps compiled against eager bit for bit and its
    compiled decode steps profiled (``check_compiled_serve``; llama3.2-1b's
    layer graph too). One model on the card at a time. Returns each run's
    launches by label."""
    out = {}
    for label, overrides in NEW_SERVE:
        graph = overrides.get("layer_graph", False)
        out[label] = run_serve(torch, label,
                               LAYER_GRAPH if graph else PER_OP,
                               **overrides)
        if not graph:
            arch = overrides["arch"]
            check_compiled_serve(torch, dev, arch, label,
                                 n_layers=overrides.get("n_layers"),
                                 layer_graph=arch == "llama3_2_1b",
                                 per_use=False, profile=True)
        torch.cuda.empty_cache()
    return out


def main_path_shapes(torch, arch=SERVE["arch"]):
    """The kernels' shapes on ``arch``'s default serve run (qwen1.5-0.5B's
    unless another is named), from its own trace."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    cfg = get_config(arch)
    page, slots = SERVE["page"], SERVE["slots"]

    def trace(prompt_len):
        return serve.make_requests(
            SERVE["requests"], prompt_len=prompt_len,
            max_new=SERVE["max_new"], rate=SERVE["rate"], vocab=cfg.vocab,
            seed=SERVE["seed"])

    reqs = trace(SERVE["prompt_len"])
    p_max = serve._bucket(max(len(r.prompt) for r in reqs))
    n_pages = max(-(-(len(r.prompt) + r.max_new) // page) for r in reqs)
    # lengths of the first lockstep batch halfway through its decode
    lengths = [len(r.prompt) + SERVE["max_new"] // 2 for r in reqs[:slots]]
    reqs256 = trace(256)
    p256 = serve._bucket(max(len(r.prompt) for r in reqs256))
    pages256 = max(-(-(len(r.prompt) + r.max_new) // page) for r in reqs256)
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"prefill": (slots * h, h // kvh, p_max, d),
            "prefill_256": (slots * h, h // kvh, p256, d),
            "decode": dict(b=slots, h=h, kvh=kvh, d=d, page=page,
                           n_pages=n_pages, n_blocks=slots * n_pages,
                           lengths=lengths),
            # the prompt-256 run's first slots at prompt + 8
            "decode_256": dict(b=slots, h=h, kvh=kvh, d=d, page=page,
                               n_pages=pages256, n_blocks=slots * pages256,
                               lengths=[len(r.prompt) + 8
                                        for r in reqs256[:slots]]),
            "decode_long": dict(b=slots, h=h, kvh=kvh, d=d, page=page,
                                n_pages=DECODE_LONG["n_pages"],
                                n_blocks=slots * DECODE_LONG["n_pages"],
                                lengths=DECODE_LONG["lengths"]),
            "layer": dict(b=slots, d=cfg.d_model, hq=h * d, f=cfg.d_ff,
                          hd=d, theta=cfg.rope_theta,
                          qkv_bias=cfg.qkv_bias,
                          positions=[n - 1 for n in lengths])}


# ---------------------------------------------------------------------------
# f. timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, n, flush=None, batch=10):
    """Mean device ms per call over ``n`` calls after warm-up, each call
    bracketed by its own CUDA events. Calls are queued in batches behind a
    ``torch.cuda._sleep`` so the device never waits on the host between a
    call's events (a batch the host could not queue before the sleep ended
    is measured again behind a longer sleep, or in smaller batches). With
    ``flush`` (a buffer larger than the 50 MB L2) rewritten before every
    call, outside its events, each call finds L2 cold."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total, count, cycles = 0.0, 0, 2_000_000
    deadline = time.perf_counter() + 120
    while count < n:
        if time.perf_counter() > deadline:
            raise RuntimeError("timing: no batch measured within 120 s")
        gate = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        gate.record()
        pairs = []
        for _ in range(batch):
            if flush is not None:
                flush.zero_()
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            fn()
            pair[1].record()
            pairs.append(pair)
        starved = gate.query()
        torch.cuda.synchronize()
        if starved:
            # a longer sleep, then (the launch queue holds about a thousand
            # entries and blocks the host when full) smaller batches
            if cycles < 2 ** 28:
                cycles *= 4
            elif batch > 1:
                batch //= 2
            else:
                raise RuntimeError("timing: the host cannot queue one call "
                                   "ahead of the device")
            continue
        total += sum(a.elapsed_time(b) for a, b in pairs)
        count += batch
    return total / count


def call_ms(torch, fn, n):
    """Mean ms per call as the caller sees it from an idle device: host
    work of the wrapper (checks, allocation, launch) plus device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    t = 0.0
    for _ in range(n):
        start.record()
        fn()
        end.record()
        end.synchronize()
        t += start.elapsed_time(end)
    return t / n


def gqa(groups):
    return {"enable_gqa": True} if groups > 1 else {}


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_kernels(torch, dev, shapes):
    import torch.nn.functional as F
    from repro_torch.kernels.ff_attention import attention, attention_ref
    gen = torch.Generator(device=dev).manual_seed(2)
    dt = torch.bfloat16
    item = 2
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}

    attn_rows = []
    for key in ("prefill", "prefill_256"):
        bh, groups, s, d = shapes[key]
        q, k, v = prefill_inputs(torch, dev, dt, bh, groups, s, d, gen)
        b, h = SERVE["slots"], bh // SERVE["slots"]
        q4 = q.view(b, h, s, d)
        k4 = k.view(b, h // groups, s, d)
        v4 = v.view(b, h // groups, s, d)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * item
        ops = 4 * d * bh * s * (s + 1) / 2           # causal (q, k) pairs
        print(f"f. timing ff_attention {key}", flush=True)
        attn_rows.append(dict(
            shape=f"q[{bh},{s},{d}] kv[{bh // groups},{s},{d}] causal bf16",
            ms=time_ms(torch, lambda: attention(q, k, v, kv_groups=groups),
                       200, flush),
            ms_hot=time_ms(torch, lambda: attention(q, k, v,
                                                    kv_groups=groups), 200),
            call_ms=call_ms(torch, lambda: attention(q, k, v,
                                                     kv_groups=groups), 100),
            plain_ms=time_ms(torch, lambda: attention_ref(
                q, k, v, kv_groups=groups), 20, flush),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, **gqa(groups)), 200, flush),
            bound=bound(nbytes, ops, "bfloat16")))
    rows["ff_attention"] = attn_rows[0]
    rows["ff_attention"]["more"] = [split_bound(r) for r in attn_rows[1:]]

    rows.update(time_decode(torch, dev, shapes))
    return rows


DECODE_TIMED = ("decode", "decode_256", "decode_long")


def time_decode(torch, dev, shapes):
    """Rows 2 and 3 at each shape of DECODE_TIMED (bf16, block_kv ==
    page, the wrappers' default depth and streams): device ms L2 cold and
    warm, ``call_ms``, the plain version, masked SDPA (contiguous only) and
    the bytes bound of the live K/V, q, out, lengths (and the table). The
    plain version's tile loop at ``decode_long`` is more launches than the
    device's queue holds, so there it is timed from an idle device
    (``plain_call_ms``, host-bound). The first shape gives each row, the
    others its ``more``."""
    import torch.nn.functional as F
    from repro_torch.kernels.ff_decode_attention import (decode_attention,
                                                         decode_attention_ref)
    from repro_torch.runtime.paged_kv import (paged_decode_attention,
                                              paged_decode_attention_ref)
    gen = torch.Generator(device=dev).manual_seed(3)
    dt, item = torch.bfloat16, 2
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {"ff_decode_attention": [], "ff_paged_decode_attention": []}
    for key in DECODE_TIMED:
        dec = shapes[key]
        q, pool, tables, lens, k, v = decode_inputs(
            torch, dev, dt, dec["b"], dec["h"], dec["kvh"], dec["d"],
            dec["page"], dec["n_pages"], dec["n_blocks"], dec["lengths"],
            gen)
        page, kvh, d = dec["page"], dec["kvh"], dec["d"]
        live = sum(min(n, dec["n_pages"] * page) for n in dec["lengths"])
        q_out = 2 * q.numel() * item + lens.numel() * 4
        kv_bytes = 2 * live * kvh * d * item
        ops = 4 * dec["h"] * d * live
        mask = (torch.arange(k.shape[2], device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        q_sdpa = q[:, :, None, :]
        grp = dec["h"] // kvh
        shape = (f"{key}: q[{dec['b']},{dec['h']},{d}] "
                 f"lengths={dec['lengths']} page={page} "
                 f"pages={dec['n_pages']} bf16")
        long = key == "decode_long"
        for name, fn, plain, library, extra, table in (
                ("ff_decode_attention",
                 lambda: decode_attention(q, k, v, lens, block_kv=page),
                 lambda: decode_attention_ref(q, k, v, lens, block_kv=page),
                 lambda: F.scaled_dot_product_attention(
                     q_sdpa, k, v, attn_mask=mask, **gqa(grp)),
                 f" cache[{dec['b']},{kvh},{k.shape[2]},{d}]", 0),
                ("ff_paged_decode_attention",
                 lambda: paged_decode_attention(q, pool, tables, lens),
                 lambda: paged_decode_attention_ref(q, pool, tables, lens),
                 None,                # no single PyTorch call reads a table
                 f" pool[{dec['n_blocks']},2,{page},{kvh},{d}]",
                 tables.numel() * 4)):
            print(f"f. timing {name} {key}", flush=True)
            row = dict(
                shape=shape + extra, ms=time_ms(torch, fn, 200, flush),
                ms_hot=time_ms(torch, fn, 200),
                call_ms=call_ms(torch, fn, 100),
                plain_ms=None if long else time_ms(torch, plain, 20, flush),
                library_ms=(time_ms(torch, library, 200, flush)
                            if library else None),
                bound=bound(q_out + kv_bytes + table, ops, "bfloat16"))
            if long:
                row["plain_call_ms"] = call_ms(torch, plain, 5)
            rows[name].append(row)
    out = {}
    for name, (first, *more) in rows.items():
        out[name] = dict(first, more=[split_bound(r) for r in more])
    return out


def time_layer_kernels(torch, dev, shapes):
    """The decode-layer kernels at the main path's shapes (B = 4, d 1024,
    16 x 64 q columns, f 2816, bf16; int32 positions, as the decode step
    passes them, so no cast is timed with the q-projection). No single
    PyTorch call computes their fused functions, so ``library_ms`` times
    the same products alone through ``torch.matmul``. The MLP tail's row
    also times its staged composition (three launches, ``staged_ms``)."""
    from repro_torch.kernels.ff_layer import (ff_layer_matmul,
                                              ff_layer_matmul_ref,
                                              ff_layer_mlp_tail,
                                              ff_layer_mlp_tail_ref,
                                              ff_layer_swiglu,
                                              ff_layer_swiglu_ref,
                                              mlp_tail_staged)
    lay = shapes["layer"]
    m, d, hq, f = lay["b"], lay["d"], lay["hq"], lay["f"]
    gen = torch.Generator(device=dev).manual_seed(5)
    t = layer_inputs(torch, dev, torch.bfloat16, m, lay, gen)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    item = 2
    q_kw = dict(norm_weight=t["nw1"], bias=t["bq"], rope_theta=lay["theta"],
                head_dim=lay["hd"],
                positions=torch.tensor(lay["positions"], device=dev,
                                       dtype=torch.int32))
    fused = {
        "ff_layer_matmul": (
            lambda: ff_layer_matmul(t["x"], t["wq"], **q_kw),
            lambda: ff_layer_matmul_ref(t["x"], t["wq"], **q_kw),
            lambda: torch.matmul(t["x"], t["wq"]),
            f"a[{m},{d}] @ wq[{d},{hq}], RMSNorm, q bias, RoPE theta "
            f"{lay['theta']:g}",
            (m * d + d * hq + hq + m * hq) * item + d * 4 + m * 4,
            2 * m * d * hq),
        "ff_layer_swiglu": (
            lambda: ff_layer_swiglu(t["x"], t["wg"], t["wu"],
                                    norm_weight=t["nw2"]),
            lambda: ff_layer_swiglu_ref(t["x"], t["wg"], t["wu"],
                                        norm_weight=t["nw2"]),
            lambda: torch.matmul(t["x"], t["wi"]),
            f"x[{m},{d}] @ wg, wu[{d},{f}] (halves of wi), RMSNorm",
            (m * d + 2 * d * f + m * f) * item + d * 4,
            4 * m * d * f),
        "ff_layer_mlp_tail": (
            lambda: ff_layer_mlp_tail(*tail_args(t)),
            lambda: ff_layer_mlp_tail_ref(*tail_args(t)),
            lambda: (torch.matmul(t["a"], t["wo"]),
                     torch.matmul(t["x"], t["wi"]),
                     torch.matmul(t["act"], t["wo2"])),
            f"a[{m},{hq}] @ wo[{hq},{d}] + x; RMSNorm, SwiGLU [{d},{f}]; "
            f"@ wo2[{f},{d}] + h",
            (m * hq + hq * d + 2 * m * d + 2 * d * f + f * d) * item + d * 4,
            2 * m * (hq * d + 2 * d * f + f * d)),
    }
    rows = {}
    for name, (kernel, plain, products, shape, nbytes, ops) in fused.items():
        print(f"f. timing {name}", flush=True)
        rows[name] = dict(
            shape=shape + " bf16",
            ms=time_ms(torch, kernel, 200, flush),
            ms_hot=time_ms(torch, kernel, 200),
            call_ms=call_ms(torch, kernel, 100),
            plain_ms=time_ms(torch, plain, 20, flush),
            library_ms=time_ms(torch, products, 200, flush),
            library="products alone (torch.matmul), not the fused function",
            bound=bound(nbytes, ops, "bfloat16"))
    def staged():
        return mlp_tail_staged(*tail_args(t))

    tail = rows["ff_layer_mlp_tail"]
    tail["staged_ms"] = time_ms(torch, staged, 200, flush)
    tail["staged_ms_hot"] = time_ms(torch, staged, 200)
    return rows


# ---------------------------------------------------------------------------
# the compiled steps against the eager ones
# ---------------------------------------------------------------------------


def tree_clone(tree):
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_clone(v) for v in tree)
    return tree.clone()


def tree_equal(torch, a, b):
    from repro_torch.launch.steps import _flatten
    la, lb = [], []
    return (_flatten(a, la) == _flatten(b, lb)
            and all(torch.equal(x, y) for x, y in zip(la, lb)))


def counted(torch, fn):
    """Every kernel wrapper's launch count over one call of ``fn`` (the
    counts set to 0 just before), after the device finished."""
    wr = wrappers()
    for w in wr.values():
        w.launches = 0
    fn()
    torch.cuda.synchronize()
    return {name: w.launches for name, w in wr.items() if w.launches}


def check_compiled_serve(torch, dev, arch, name, n_layers=None,
                         layer_graph=True, per_use=True, profile=False):
    """``arch``'s serve steps at full width (random weights from seed 0,
    cast once; ``n_layers`` cuts the depth) replayed from their CUDA
    graphs against the same steps run eagerly, bit for bit: the default
    run's first bucket prefill (4 x its first batch), then two decode
    steps through the dense cache, the paged pool and (``layer_graph``)
    the layer graph, and a replay's launch counts against an eager
    step's. With ``per_use`` also the cast-once weights against the
    per-use cast (the f32 tree must fit: qwen1.5-0.5B's does). With
    ``profile``, a ``profile[name]`` line: each kind's compiled decode
    step (``profile_steps``: wall, busy share, device kernels, the top
    kernels)."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.runtime.paged_kv import PagedKVCache
    page, slots = SERVE["page"], SERVE["slots"]
    cfg = get_config(arch).replace(decode_block_kv=page)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    model = build_model(cfg)
    models = {"dense": model, "paged": model}
    if layer_graph:
        models["layer-graph"] = build_model(cfg.replace(layer_graph=True))
    gen = torch.Generator(device=dev).manual_seed(0)
    if per_use:
        per_use = model.init(gen, dev)
        params = model.cast_params(per_use)
    else:
        params = model.init_cast(gen, dev)
    reqs = serve.make_requests(
        SERVE["requests"], prompt_len=SERVE["prompt_len"],
        max_new=SERVE["max_new"], rate=SERVE["rate"], vocab=cfg.vocab,
        seed=SERVE["seed"])[:slots]
    lens = np.array([len(r.prompt) for r in reqs], np.int32)
    p_max = serve._bucket(int(lens.max()))
    n_pages = -(-(p_max + 4) // page)
    toks = np.zeros((slots, p_max), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = r.prompt
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    prefill_e = steps.make_prefill_step(model, compiled=False)
    want = tree_clone(prefill_e(params, batch))
    got = [tree_clone(steps.make_prefill_step(model)(params, batch))
           for _ in range(2)]
    check(f"compiled {name} prefill ({slots} x {p_max}) == eager bitwise, "
          f"capture and replay", all(tree_equal(torch, g, want)
                                     for g in got),
          "logits and K/V caches")
    if per_use:
        check(f"cast-once weights == per-use cast ({name} prefill logits)",
              torch.equal(prefill_e(per_use, batch)[0], want[0]),
              "bitwise, bf16")
    dense = want[1]

    def cache_for(kind, n_pages=n_pages):
        if kind != "paged":
            return serve.pad_cache_to(dense, p_max, n_pages * page, 2)
        kv = PagedKVCache(
            n_layers=cfg.n_layers, n_blocks=slots * n_pages + 1, page=page,
            kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, n_slots=slots,
            n_pages_max=n_pages, dtype=cfg.cdtype, device=dev)
        for i, n in enumerate(lens):
            kv.admit(i, dense["k"][:, i], dense["v"][:, i], int(n),
                     n_pages * page)
        return kv.cache_view()

    start = {"token": torch.as_tensor(toks[np.arange(slots), lens - 1],
                                      device=dev),
             "lengths": torch.as_tensor(lens - 1, device=dev)}
    for kind, m in models.items():
        sides = {}
        for compiled in (True, False):
            decode = steps.make_decode_step(m, compiled=compiled)
            b, cache, outs = dict(start), cache_for(kind), []
            for _ in range(2):
                nxt, lg, cache = decode(params, b, cache)
                outs.append(tree_clone((nxt, lg, cache)))
                b = {"token": nxt, "lengths": b["lengths"] + 1}
            sides[compiled] = outs
        check(f"compiled {name} {kind} decode == eager bitwise, capture "
              f"and replay", all(tree_equal(torch, c, e) for c, e in
                                 zip(sides[True], sides[False])),
              "next tokens, logits and the cache written, two steps")
        cache = cache_for(kind)
        eager = counted(torch, lambda: steps.make_decode_step(
            m, compiled=False)(params, dict(start), tree_clone(cache)))
        replay = counted(torch, lambda: steps.make_decode_step(m)(
            params, dict(start), cache))
        check(f"compiled {name} {kind} decode: a replay counts the eager "
              f"step's launches", replay == eager and replay,
              f"replay {replay}, eager {eager}")
    if per_use:
        cache = cache_for("dense")
        check(f"cast-once weights == per-use cast ({name} dense decode "
              f"logits)",
              torch.equal(steps.make_decode_step(model, compiled=False)(
                  params, dict(start), tree_clone(cache))[1],
                  steps.make_decode_step(model, compiled=False)(
                  per_use, dict(start), cache)[1]), "bitwise, bf16")
    if profile:
        n_steps, rounds = 8, 3
        rows = p_max + (rounds + 2) * n_steps + 2   # every step's cache row
        fns = {}
        for kind, m in models.items():
            state = {"b": dict(start),
                     "cache": cache_for(kind, -(-rows // page))}

            def step(decode=steps.make_decode_step(m), state=state):
                nxt, _, state["cache"] = decode(params, state["b"],
                                                state["cache"])
                nxt.cpu()                    # as a scheduler reads it
                state["b"] = {"token": nxt,
                              "lengths": state["b"]["lengths"] + 1}
            fns[f"{kind} compiled"] = step
        out = profile_steps(torch, fns, n_steps, rounds)
        for p in out.values():
            del p["by_name"], p["count"]
        nbytes = decode_weight_bytes(cfg, L.tree_leaves(params))
        print(f"profile[{name}] " + json.dumps({
            "decode_weight_bytes_read": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, **out}), flush=True)


def check_compiled_steps(torch, dev):
    """Each step kind replayed from a CUDA graph against the same step run
    eagerly (``compiled=False``) from the same inputs, bit for bit: the
    logits, the greedy tokens and every cache leaf it returns, over two
    steps (the first call warms up, captures and replays, the second only
    replays). The kinds: qwen1.5-0.5B at full width
    (:func:`check_compiled_serve`); rwkv6-7b and zamba2-2.7b at smoke
    width in bf16, prefill and decode (phase e runs them at full
    width)."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import build_model
    check_compiled_serve(torch, dev, SERVE["arch"], "qwen")

    for arch in SSM["archs"]:
        scfg = smoke_config(arch).replace(compute_dtype="bfloat16")
        smodel = build_model(scfg)
        sparams = smodel.init_cast(torch.Generator(device=dev).manual_seed(0),
                                   dev)
        stoks = torch.randint(1, scfg.vocab, (2, 40), dtype=torch.int32,
                              device=dev, generator=torch.Generator(
                                  device=dev).manual_seed(1))
        sides = {}
        for compiled in (True, False):
            prefill = steps.make_prefill_step(smodel, compiled=compiled)
            decode = steps.make_decode_step(smodel, compiled=compiled)
            logits, cache = prefill(sparams, {"tokens": stoks})
            outs = [tree_clone((logits, cache))]
            if scfg.family == "hybrid":
                cache = serve.pad_cache_to(tree_clone(cache), 40, 42,
                                           {"mamba": None, "attn": 1})
            b = {"token": torch.argmax(logits, -1).to(torch.int32),
                 "lengths": torch.full((2,), 40, dtype=torch.int32,
                                       device=dev)}
            for _ in range(2):
                nxt, lg, cache = decode(sparams, b, cache)
                outs.append(tree_clone((nxt, lg, cache)))
                b = {"token": nxt, "lengths": b["lengths"] + 1}
            sides[compiled] = outs
        check(f"compiled smoke {arch} bf16 prefill and decode == eager "
              f"bitwise", all(tree_equal(torch, c, e)
                              for c, e in zip(sides[True], sides[False])),
              "logits, next tokens and the states, prefill and two decode "
              "steps")


# ---------------------------------------------------------------------------
# g. where a full-width decode step's time goes
# ---------------------------------------------------------------------------


# the CUDA runtime calls that put kernels on the device (a graph's replay
# is one cudaGraphLaunch), and those that copy or set memory
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")
PROFILE_GAP_S = 0.005
COPY_CALLS = ("cudaMemcpyAsync", "cudaMemsetAsync", "cuMemcpyAsync",
              "cuMemsetD8Async", "cuMemsetD32Async")


def device_profile(prof, n_steps):
    """A torch.profiler window of ``n_steps`` steps, per step: the
    device's busy ms (kernel and copy times, summed; one stream), device
    kernels and copies, host launch calls (kernel and graph launches) and
    host copy calls; with each device op's total ms and count."""
    from torch.autograd import DeviceType
    by_name, count = {}, {}
    launches = copies = graphs = 0
    for e in prof.events():
        if e.name.startswith("ProfilerStep"):
            continue                # the window's own annotation, no op
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
            count[e.name] = count.get(e.name, 0) + 1
        elif e.name in LAUNCH_CALLS:
            launches += 1
            graphs += "Graph" in e.name
        elif e.name in COPY_CALLS:
            copies += 1
    busy = sum(by_name.values()) / n_steps if by_name else None
    return {"device_ms": busy,
            "device_kernels": sum(c for n, c in count.items()
                                  if "Memcpy" not in n
                                  and "Memset" not in n) / n_steps,
            "device_ops": sum(count.values()) / n_steps,
            "host_launch_calls": launches / n_steps,
            "host_graph_launches": graphs / n_steps,
            "host_copy_calls": copies / n_steps,
            "by_name": by_name, "count": count}


def profile_window(torch, step, n_steps):
    """``device_profile`` of one window of ``n_steps`` calls of ``step``,
    after a warm-up window of as many calls that the profiler traces and
    drops: device tracing is running before the counted window starts,
    so its first kernels are not lost to the start of the trace. Each
    window idles PROFILE_GAP_S on the host after its start and before its
    end: the profiler keeps a device op only if its device times, mapped
    onto the host's clock, fall inside the window, so a kernel launched
    right at an edge could fall on the wrong side of it."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(PROFILE_GAP_S)
            for _ in range(n_steps):
                step()
            torch.cuda.synchronize()
            time.sleep(PROFILE_GAP_S)
            prof.step()
    return device_profile(prof, n_steps)


def profile_steps(torch, steps, n_steps, rounds, fits=None):
    """Wall ms per step of each of ``steps`` (name -> a function running
    one step that ends in a host read, as a scheduler's does): two
    unclocked steps each, then ``rounds`` windows of ``n_steps`` steps,
    the steps in turn (the order reversed every other round: the host's
    speed drifts, so only windows of one call are compared), the median
    window with every window beside it; then one profiled window each
    (``device_profile``): busy ms and share, device kernels, host launch
    calls per step and the top device ops. ``fits(name, profile)`` says
    whether a window holds every launch the step is known to make; a
    window that does not (the profiler lost device events) is profiled
    once more, and the lost one's device ops a step are kept beside the
    new window's as ``lost_window``."""
    import numpy as np
    names = list(steps)
    walls = {name: [] for name in names}
    for name in names:
        for _ in range(2):
            steps[name]()
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                steps[name]()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3 / n_steps)
    out = {}
    for name in names:
        p = profile_window(torch, steps[name], n_steps)
        lost = None
        if fits is not None and not fits(name, p):
            lost = {"device_ops_per_step": p["device_ops"],
                    "device_kernels_per_step": p["device_kernels"]}
            p = profile_window(torch, steps[name], n_steps)
            lost["events_lost_per_step"] = (p["device_ops"]
                                            - lost["device_ops_per_step"])
        wall = float(np.median(walls[name]))
        busy = p["device_ms"]
        top = sorted(p["by_name"].items(), key=lambda kv_: -kv_[1])[:8]
        out[name] = {
            "wall_ms_per_step": wall,
            "wall_ms_per_step_windows": walls[name],
            "device_ms_per_step": busy,
            "device_busy_share": busy / wall if busy is not None else None,
            "device_kernels_per_step": p["device_kernels"],
            "device_ops_per_step": p["device_ops"],
            "host_launch_calls_per_step": p["host_launch_calls"],
            "host_graph_launches_per_step": p["host_graph_launches"],
            "host_copy_calls_per_step": p["host_copy_calls"],
            "top_kernels_ms_per_step": [[n[:80], t / n_steps,
                                         p["count"][n] / n_steps]
                                        for n, t in top],
            "lost_window": lost,
            "by_name": p["by_name"], "count": p["count"]}
    return out


def profile_decode(torch, dev, n_steps=8, rounds=5):
    """Where a full-width serve decode step's time goes, compiled (CUDA
    graphs, the schedulers' default) and eager, for the dense cache
    (lockstep), the paged pool (continuous batching) and the layer graph
    (lockstep with ``--layer-graph``) at the default serve shapes: the
    first ``slots`` requests of the default trace, decoding from their
    prompts, weights cast once. The six steps are timed in turn in one
    call (``profile_steps``); per step: wall (median window and every
    window), busy ms and share, device kernels, host launch calls, and
    the decode-attention kernels', MLP tail's and q-projection's ms and
    launches. Fails unless the layer graph runs one MLP-tail kernel and
    one q-projection per layer per step, compiled and eager."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import build_model
    from repro_torch.runtime.paged_kv import PagedKVCache
    page, slots = SERVE["page"], SERVE["slots"]
    kinds = ("dense", "paged", "layer-graph")
    cfg = get_config(SERVE["arch"]).replace(decode_block_kv=page)
    model = build_model(cfg)
    graph_model = build_model(cfg.replace(layer_graph=True))
    params = model.init_cast(torch.Generator(device=dev).manual_seed(0), dev)
    reqs = serve.make_requests(
        SERVE["requests"], prompt_len=SERVE["prompt_len"],
        max_new=SERVE["max_new"], rate=SERVE["rate"], vocab=cfg.vocab,
        seed=SERVE["seed"])[:slots]
    lens = np.array([len(r.prompt) for r in reqs], np.int32)
    p_max = serve._bucket(int(lens.max()))
    n_pages = -(-(p_max + 2 + (rounds + 1) * n_steps) // page)
    toks = np.zeros((slots, p_max), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = r.prompt
    prefill = steps.make_prefill_step(model)
    _, dense = prefill(params, {"tokens": torch.as_tensor(toks, device=dev)})
    dense = {k: x.clone() for k, x in dense.items()}

    from repro_torch.core.program import PipePolicy
    policies = {"": None, " constants": PipePolicy(**CONSTANTS),
                " baseline": PipePolicy(mode="baseline")}

    def make_step(kind, compiled, policy=None):
        decode = steps.make_decode_step(
            graph_model if kind == "layer-graph" else model,
            compiled=compiled, policy=policy)
        if kind == "paged":
            kv = PagedKVCache(
                n_layers=cfg.n_layers, n_blocks=slots * n_pages, page=page,
                kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, n_slots=slots,
                n_pages_max=n_pages, dtype=cfg.cdtype, device=dev)
            for i, n in enumerate(lens):
                kv.admit(i, dense["k"][:, i], dense["v"][:, i], int(n),
                         n_pages * page)
            cache = kv.cache_view()
        else:
            cache = serve.pad_cache_to(dense, p_max, n_pages * page, 2)
        state = {"cur": torch.as_tensor(toks[np.arange(slots), lens - 1],
                                        device=dev),
                 "len": torch.as_tensor(lens - 1, device=dev),
                 "cache": cache}

        def step():
            state["cur"], _, state["cache"] = decode(
                params, {"token": state["cur"], "lengths": state["len"]},
                state["cache"])
            state["cur"].cpu()                   # the schedulers read it
            state["len"] = state["len"] + 1
        return step

    def fits(name, p):
        # the layer graph launches one MLP tail and one q-projection a
        # layer every step, replayed or eager: fewer in a window means the
        # profiler lost device events
        return not name.startswith("layer-graph") or all(
            sum(c for n, c in p["count"].items() if tag in n)
            == cfg.n_layers * n_steps
            for tag in ("ring_mlp_tail_kernel", "ring_matmul_kernel"))

    runs = profile_steps(torch, {
        **{f"{kind} {mode}": make_step(kind, mode == "compiled")
           for kind in kinds for mode in ("compiled", "eager")},
        **{f"{kind} compiled{tag}": make_step(kind, True, pol)
           for kind in kinds for tag, pol in policies.items() if pol}},
        n_steps, rounds, fits)
    for name, r in runs.items():
        by_name, count = r.pop("by_name"), r.pop("count")

        def ms(tag):
            return sum(v for n, v in by_name.items() if tag in n) / n_steps

        def calls(tag):
            return sum(c for n, c in count.items() if tag in n) / n_steps

        r.update(decode_attention_launches_per_step=calls("decode_kernel"),
                 decode_attention_ms_per_step=ms("decode_kernel"),
                 decode_attention_share=(ms("decode_kernel")
                                         / r["device_ms_per_step"]
                                         if r["device_ms_per_step"]
                                         else None),
                 mlp_tail_launches_per_step=calls("ring_mlp_tail_kernel"),
                 mlp_tail_ms_per_step=ms("ring_mlp_tail_kernel"),
                 qproj_launches_per_step=calls("ring_matmul_kernel"),
                 qproj_ms_per_step=ms("ring_matmul_kernel"))
        if name.startswith("layer-graph"):
            check(f"profile {name}: one MLP-tail launch per layer per step",
                  r["mlp_tail_launches_per_step"] == cfg.n_layers,
                  f"{r['mlp_tail_launches_per_step']} per step, "
                  f"{cfg.n_layers} layers")
            check(f"profile {name}: one q-projection launch per layer per "
                  f"step", r["qproj_launches_per_step"] == cfg.n_layers,
                  f"{r['qproj_launches_per_step']} per step, "
                  f"{cfg.n_layers} layers")
    print("profile " + json.dumps(runs), flush=True)
    return runs


# ---------------------------------------------------------------------------
# h. the plan stack
# ---------------------------------------------------------------------------


def eager_autotune(torch, dev):
    """One eager call under ``autotune`` with an empty plan cache: decode
    attention at the serve run's shape, which measures its candidates on
    the card (outside any capture) and must give the ``ff`` call's bits.
    Returns whether the two outputs are equal."""
    from repro_torch.core import autotune
    from repro_torch.core.program import PipePolicy
    from repro_torch.kernels.ff_decode_attention import ops as DO
    gen = torch.Generator(device=dev).manual_seed(12)
    bf = torch.bfloat16
    q = torch.randn(4, 16, 64, generator=gen, device=dev).to(bf)
    k = torch.randn(4, 16, 48, 64, generator=gen, device=dev).to(bf)
    v = torch.randn(4, 16, 48, 64, generator=gen, device=dev).to(bf)
    lens = torch.tensor([14, 23, 31, 19], dtype=torch.int32, device=dev)
    autotune.tuned_cache_clear()
    tuned = DO.decode_attention(q, k, v, lens, block_kv=16,
                                policy=PipePolicy(mode="autotune"))
    planned = DO.decode_attention(q, k, v, lens, block_kv=16)
    return bool(torch.equal(tuned, planned))


def plan_serves(torch, dev, tmp):
    """Serve full-width qwen1.5-0.5B at the serve defaults under each
    policy (``ff``, ``baseline``, ``autotune``, the old constants as the
    session policy), record its traffic, sweep it on the card into a
    PlanDB and serve again from it; then one eager ``autotune`` kernel
    call. Returns the summary of the ``plans`` line. Admissions follow
    the measured step times, so runs batch requests differently; each
    request's own greedy tokens (by rid, per scheduler) must not move."""
    import os
    import warnings
    import repro_torch
    from repro_torch.core import autotune
    from repro_torch.core.program import PipePolicy
    from repro_torch.launch import serve
    from repro_torch.plans import TrafficProfile
    from repro_torch.plans import plandb as plandb_lib

    os.environ["REPRO_TORCH_PLAN_CACHE"] = str(tmp / "host.json")
    in_capture = []
    real_measure = autotune.measure

    def measure(fn, **kw):
        in_capture.append(autotune.in_capture())
        return real_measure(fn, **kw)
    autotune.measure = measure
    profile, metrics, db = (tmp / "traffic.json", tmp / "metrics.json",
                            tmp / "plandb.json")
    runs, outputs = {}, {}

    def bench(label, session=None, **over):
        autotune.plan_stats_clear()
        t0 = time.perf_counter()
        with warnings.catch_warnings(), repro_torch.policy(session):
            # measured policies inside a capture fall back, warned
            warnings.simplefilter("ignore", RuntimeWarning)
            result = serve.serve_bench(Namespace(**{**SERVE, **over}))
        torch.cuda.synchronize()
        outputs[label] = {k: result[k]["outputs"]
                          for k in ("lockstep", "paged")}
        stats = autotune.plan_stats_snapshot()
        runs[label] = {
            "wall_s": time.perf_counter() - t0,
            "policy_mode": result["policy_mode"],
            "tokens": [result[k]["tokens"] for k in ("lockstep", "paged")],
            "decode_steps": [result[k]["decode_steps"]
                             for k in ("lockstep", "paged")],
            "decode_ms": [1e3 * result[k]["decode_s"]
                          / max(result[k]["decode_steps"], 1)
                          for k in ("lockstep", "paged")],
            "bitwise_max_abs_diff": result["bitwise_max_abs_diff"],
            "plan_sources": {k: v for k, v in stats.items()
                             if k not in ("lookups", "hits", "hit_rate")},
            "plan_service": result.get("plan_service")}
        check(f"plans[{label}]: paged == dense decode bit for bit",
              result["bitwise_max_abs_diff"] == 0.0,
              f"max |diff| {result['bitwise_max_abs_diff']}")

    bench("ff", record_profile=str(profile), metrics_json=str(metrics))
    bench("baseline", policy_mode="baseline")
    bench("autotune", policy_mode="autotune")
    bench("constants", session=PipePolicy(**CONSTANTS))
    check("plans: the constants run served under the session policy",
          runs["constants"]["policy_mode"] == "ff",
          f"policy_mode {runs['constants']['policy_mode']}")
    snap = json.loads(metrics.read_text())
    names = {label.partition("{")[0] for kind in snap.values()
             for label in kind}
    check("plans: the metrics JSON parses with the reference's names",
          names == {"plan_resolutions_total", "serve_token_latency_seconds",
                    "serve_kv_utilization"}, f"{sorted(names)}")
    recorded = TrafficProfile.load(str(profile))
    t0 = time.perf_counter()
    sweep = subprocess.run(
        [sys.executable, "-m", "repro_torch.plans", "sweep", "--profile",
         str(profile), "--db", str(db), "--budget-s", "30", "--iters", "3",
         "--top-k", "4", "--scratch-cache", str(tmp / "scratch.json"),
         "--device", SERVE["device"]],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=str(ROOT))
    sweep_s = time.perf_counter() - t0
    tail = sweep.stdout.strip().splitlines()[-40:]
    check("plans: python -m repro_torch.plans sweep on the card",
          sweep.returncode == 0 and db.exists(),
          f"rc {sweep.returncode}, {sweep_s:.1f} s; "
          f"{sweep.stderr.strip()[-500:]}")
    os.environ["REPRO_TORCH_PLAN_CACHE"] = str(tmp / "fresh.json")
    autotune.tuned_cache_clear()
    plandb_lib.clear_cache()
    bench("plan-db", policy_mode="autotune", plan_db=str(db))
    hits = runs["plan-db"]["plan_sources"].get("plandb", 0)
    check("plans: the PlanDB served the autotune run", hits > 0,
          f"{hits} PlanDB hits")
    same = {label: all(o[k] == outputs["ff"][k] for k in o)
            for label, o in outputs.items()}
    n_tokens = sum(map(len, outputs["ff"]["paged"].values()))
    check("plans: each request's tokens the same in every run (by rid, "
          "each scheduler)", all(same.values()) and n_tokens > 0,
          f"{same}, {len(outputs['ff']['paged'])} requests, {n_tokens} "
          f"paged tokens a run")
    in_serves = len(in_capture)
    os.environ["REPRO_TORCH_PLAN_CACHE"] = str(tmp / "eager.json")
    eager_equal = eager_autotune(torch, dev)
    autotune.measure = real_measure
    check("plans: an eager autotune call measures on the card, with the "
          "planned call's bits", len(in_capture) > in_serves and eager_equal,
          f"{len(in_capture) - in_serves} measurements, equal "
          f"{eager_equal}")
    check("plans: no measurement inside a capture", not any(in_capture),
          f"{len(in_capture)} measurements ({in_serves} in the serves), "
          f"{sum(in_capture)} in captures")
    return {"serves": runs, "tokens_equal": same,
            "profile": {"buckets": len(recorded),
                        "observations": recorded.total_count},
            "sweep": {"rc": sweep.returncode, "wall_s": sweep_s,
                      "stdout_tail": tail},
            "measurements": len(in_capture),
            "measurements_in_serves": in_serves,
            "measurements_in_capture": sum(in_capture)}


def resolution_us(torch, n=2000):
    """Host microseconds of one plan resolution as an eager kernel call
    pays it (``autotune.resolve_call`` under ``ff``, a cache hit: decode
    attention at the serve run's shape), and of the whole eager call of
    that kernel on the card (resolution, checks, launch; no sync)."""
    from repro_torch.core import autotune
    from repro_torch.core.program import PipePolicy
    from repro_torch.kernels.ff_decode_attention import ops as DO
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    w, tile = DO.decode_attention_workload(4, 16, 16, 48, 64, dtype=bf)
    pol = PipePolicy()
    kw = dict(workload=w, tile=tile, dtype=bf, depth_cap=14,
              extra_key="block_kv=16", site={"b": 4, "s": 48},
              site_dynamic=("b", "s"))
    autotune.resolve_call("ff_decode_attention", pol, **kw)
    t0 = time.perf_counter()
    for _ in range(n):
        autotune.resolve_call("ff_decode_attention", pol, **kw)
    resolve = (time.perf_counter() - t0) / n * 1e6
    q = torch.randn(4, 16, 64, device=dev).to(bf)
    k = torch.randn(4, 16, 48, 64, device=dev).to(bf)
    lens = torch.tensor([14, 23, 31, 19], dtype=torch.int32, device=dev)
    DO.decode_attention(q, k, k, lens, block_kv=16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n // 10):
        DO.decode_attention(q, k, k, lens, block_kv=16)
    call = (time.perf_counter() - t0) / (n // 10) * 1e6
    torch.cuda.synchronize()
    return {"resolve_call_us": resolve, "eager_decode_call_us": call}


def decode_waves(torch, shapes):
    """Decode attention's one-wave depth cap (``ops.wave_depth``, from its
    shared-memory and thread model of an SM) against the cap the card's
    own occupancy gives (``ff_decode_attention_occupancy``: registers,
    shared memory, threads), for both launches at the serve, ``decode_256``
    and ``decode_long`` shapes; fails where they differ."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ff_decode_attention import ops as DO
    occ = _build.load("ff_decode_attention").ff_decode_attention_occupancy
    occ.argtypes = [ctypes.c_int] * 6
    occ.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bf = torch.bfloat16
    out = {}
    for key in ("decode", "decode_256", "decode_long"):
        dec = shapes[key]
        b, kvh, d = dec["b"], dec["kvh"], dec["d"]
        group, s = dec["h"] // kvh, dec["n_pages"] * dec["page"]
        deepest = DO.max_depth(d, bf, group)
        blocks = b * kvh * DO._plan(b, kvh, d, bf, s, sms).split
        rows = DO._word_rows(d, bf)
        card = {paged: [occ(1, paged, rows, d, group, x)
                        for x in range(1, deepest + 1)] for paged in (0, 1)}

        def cap(resident):
            def waves(x):
                return -(-blocks // (sms * max(resident[x - 1], 1)))
            x = deepest
            while x > 1 and waves(x) > waves(1):
                x -= 1
            return x
        model = DO.wave_depth(b, kvh, d, bf, s, sms, group)
        out[key] = {"blocks": blocks, "sms": sms,
                    "resident_model": [DO.resident_blocks(x, d, bf, group)
                                       for x in range(1, deepest + 1)],
                    "resident_card": card[0], "resident_card_paged": card[1],
                    "cap_model": model, "cap_card": [cap(card[0]),
                                                     cap(card[1])]}
        check(f"plans: decode {key}: the one-wave depth cap of the card's "
              f"occupancy is the model's", out[key]["cap_card"] == [model,
                                                                    model],
              f"model {model}, card {out[key]['cap_card']}, {blocks} blocks")
    return out


def plan_phase(torch, dev, sweep, runs, shapes):
    """Phase h: the ``plans`` line."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip-smoke-plans-") as d:
        out = plan_serves(torch, dev, Path(d))
    steps = {}
    for kind in ("dense", "paged", "layer-graph"):
        row = {}
        for tag, label in (("", "ff"), (" constants", "constants"),
                           (" baseline", "baseline")):
            r = runs[f"{kind} compiled{tag}"]
            row[label] = {"wall_ms": r["wall_ms_per_step"],
                          "device_ms": r["device_ms_per_step"]}
        row["ff_over_constants_device"] = (row["ff"]["device_ms"]
                                           / row["constants"]["device_ms"])
        steps[kind] = row
    out.update(compiled_steps=steps, fit=fit_h100(sweep),
               fit_regular=regular_fits(sweep), planned=sweep["planned"],
               decode_waves=decode_waves(torch, shapes),
               host=resolution_us(torch))
    print("plans " + json.dumps(out), flush=True)


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# i. training on one card
# ---------------------------------------------------------------------------


def smi_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}")


def train_batch(torch, cfg, batch, seq, step=0):
    """The trainer's synthetic batch (``data.batch_at``) as CPU tensors."""
    from repro_torch.data import SyntheticSpec, batch_at
    spec = SyntheticSpec(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch,
        n_frames=cfg.n_frames if cfg.family == "encdec" else 0,
        n_patches=cfg.n_patches if cfg.family == "vlm" else 0,
        d_model=cfg.d_model)
    return {k: torch.from_numpy(v) for k, v in batch_at(spec, step).items()}


def leaf_errs(torch, got, want):
    """max |got - want| / max |want| over each leaf pair (paths sorted)."""
    from repro_torch.models import layers as L
    w = dict(L.tree_leaves(want))
    return {path: err(g.cpu(), w[path]) / max(w[path].abs().max().item(),
                                              1e-30)
            for path, g in L.tree_leaves(got)}


def check_train_small(torch, dev, card):
    """The smoke models of TRAIN_SMALL at f32 compute on the "xla" path:
    loss and every gradient leaf on the card against the CPU, then one
    AdamW and one Adafactor update of the card's copy and of the CPU's,
    given the CPU's gradients."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import build_model
    from repro_torch.optim import adafactor, adamw
    for arch in TRAIN_SMALL:
        cfg = smoke_config(arch).replace(attn_impl="xla", scan_impl="xla",
                                         compute_dtype="float32")
        model = build_model(cfg)
        p_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
        p_dev = tree_to(p_cpu, dev, torch)
        batch = train_batch(torch, cfg, 2, 32)
        m_cpu, g_cpu = value_and_grad(model, p_cpu, batch)
        m_dev, g_dev = value_and_grad(model, p_dev, tree_to(batch, dev,
                                                            torch))
        loss_e = abs(m_dev["loss"].item() - m_cpu["loss"].item()) / abs(
            m_cpu["loss"].item())
        g_errs = leaf_errs(torch, g_dev, g_cpu)
        worst = max(g_errs, key=g_errs.get)
        g_tol = (TRAIN_SSM_GRAD_TOL if cfg.family in ("ssm", "hybrid")
                 else TRAIN_GRAD_TOL)
        opt_e = {}
        for name, opt in (("adamw", adamw), ("adafactor", adafactor)):
            cfg_o = (opt.AdamWConfig() if name == "adamw"
                     else opt.AdafactorConfig())
            with torch.no_grad():
                a = tree_clone(p_cpu)
                b = tree_to(p_cpu, dev, torch)
                opt.update(cfg_o, g_cpu, opt.init(a), a)
                opt.update(cfg_o, tree_to(g_cpu, dev, torch), opt.init(b),
                           b)
            opt_e[name] = max(leaf_errs(torch, b, a).values())
        check(f"train smoke {arch} card vs cpu ({card})",
              loss_e <= TRAIN_LOSS_TOL and g_errs[worst] <= g_tol
              and all(e <= TRAIN_OPT_TOL for e in opt_e.values()),
              f"loss {m_dev['loss'].item():.6f} rel err {loss_e:.2e} "
              f"(tol {TRAIN_LOSS_TOL}); grads {len(g_errs)} leaves, worst "
              f"{'.'.join(worst)} {g_errs[worst]:.2e} of max|cpu| (tol "
              f"{g_tol}); one update given the same grads: adamw "
              f"{opt_e['adamw']:.2e}, adafactor {opt_e['adafactor']:.2e} of "
              f"max|param| (tol {TRAIN_OPT_TOL})")


def train_args(ckpt_dir, **kw):
    from repro_torch.launch import train
    argv = ["--ckpt-dir", ckpt_dir, "--log-every", "1", "--device", "cuda"]
    for k, v in kw.items():
        flag = "--" + k.replace("_", "-")
        argv += [flag] if v is True else [flag, str(v)]
    return train.build_parser().parse_args(argv)


def train_full(torch, dev, card, tmp):
    """Full-width llama3.2-1b (the reference trainer's default model)
    through ``launch/train.py``: TRAIN's steps at its batch and sequence
    on the "xla" path in bf16 compute, f32 params, gradients and AdamW
    moments, the step compiled (one CUDA graph, AdamW's kernel inside);
    then TRAIN's accumulation run. Returns the train path's launches of
    every kernel wrapper (the counts zeroed just before)."""
    from repro_torch.launch import train
    wr = wrappers()
    for w in wr.values():
        w.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ck = str(Path(tmp) / "full")
    r = train.run(train_args(ck, arch=TRAIN["arch"], steps=TRAIN["steps"],
                             batch=TRAIN["batch"], seq=TRAIN["seq"],
                             lr=TRAIN["lr"], ckpt_every=10 ** 6))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [m["loss"] for m in r["metrics"]]
    first, last = (sum(losses[:5]) / 5, sum(losses[-5:]) / 5)
    finite = all(math.isfinite(x) for x in losses)
    adamw_launches = wr["adamw"].launches
    step_ms = sorted(t * 1e3 for t in r["step_s"][1:])
    med = step_ms[len(step_ms) // 2] if len(step_ms) % 2 else (
        step_ms[len(step_ms) // 2 - 1] + step_ms[len(step_ms) // 2]) / 2
    tokens = TRAIN["batch"] * TRAIN["seq"]
    ckpt = r["checkpoint"]
    from repro_torch.models import layers as L
    n_params = sum(x.numel() for _, x in L.tree_leaves(r["state"]["params"]))
    check(f"train[{TRAIN['arch']}] full width, {TRAIN['steps']} steps",
          finite and last < first and len(losses) == TRAIN["steps"],
          f"{n_params} params; losses finite: {finite}, first 5 mean "
          f"{first:.4f}, last 5 mean {last:.4f}, margin {first - last:.4f}")
    print("train " + json.dumps({
        "arch": TRAIN["arch"], "batch": TRAIN["batch"], "seq": TRAIN["seq"],
        "steps": TRAIN["steps"], "lr": TRAIN["lr"], "params": n_params,
        "losses": losses,
        "median_step_ms_after_first": med, "first_step_ms":
        r["step_s"][0] * 1e3, "tokens_per_s": tokens / (med / 1e3),
        "peak_gib": peak / 2 ** 30,
        "checkpoint_gb": ckpt["bytes"] / 1e9,
        "checkpoint_write_s": ckpt["seconds"], "compiled": True,
        "adamw_launches": adamw_launches, "card": card}), flush=True)
    del r
    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()
    ck = str(Path(tmp) / "accum")
    r = train.run(train_args(ck, arch=TRAIN["arch"],
                             steps=TRAIN["accum_steps"],
                             batch=TRAIN["batch"], seq=TRAIN["seq"],
                             lr=TRAIN["lr"], accum=TRAIN["accum"],
                             quantized_accum=True, ckpt_every=0))
    losses = [m["loss"] for m in r["metrics"]]
    check(f"train[{TRAIN['arch']}] --accum {TRAIN['accum']} "
          f"--quantized-accum, {TRAIN['accum_steps']} steps",
          len(losses) == TRAIN["accum_steps"]
          and all(math.isfinite(x) for x in losses),
          f"losses {[round(x, 4) for x in losses]}; median step "
          f"{sorted(r['step_s'])[len(r['step_s']) // 2] * 1e3:.1f} ms "
          f"({card})")
    del r
    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {name: w.launches for name, w in wr.items()}


def run_train_steps(torch, dev, model, state, batches, compiled, **kw):
    """``make_train_step(model, compiled=compiled, **kw)`` on ``state``
    ({"params", "opt"}, written in place) for each of ``batches`` (CPU
    trees), each written into one set of device tensors as the trainer
    writes them. Returns (each step's metrics as floats, the first call's
    ms, ``one``: one more call on the last batch, synced)."""
    from repro_torch.launch import steps
    step = steps.make_train_step(model, compiled=compiled, **kw)
    bufs = {k: torch.empty_like(v, device=dev) for k, v in
            batches[0].items()}
    metrics, first_ms = [], None
    for b in batches:
        for k, v in b.items():
            bufs[k].copy_(v)
        t0 = time.perf_counter()
        _, _, m = step(state["params"], state["opt"], bufs)
        metrics.append({k: v.item() for k, v in m.items()})
        if first_ms is None:
            first_ms = (time.perf_counter() - t0) * 1e3

    def one():
        step(state["params"], state["opt"], bufs)[2]["loss"].item()
    one.step = getattr(step, "step", step)      # a policy's step wraps it
    return metrics, first_ms, one


def step_profile(torch, dev, one, first_ms, base, n_steps=2):
    """After a run's checked calls: the wall ms a call over three more,
    then one profiled window of ``n_steps`` (``profile_window``, which
    makes 2 x ``n_steps`` calls): device busy ms and share, device
    kernels and host launch calls a step, the AdamW kernel's share of the
    device ms, the top device ops, and the run's peak memory above
    ``base`` (what was allocated before its state was made)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        one()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    prof = profile_window(torch, one, n_steps)
    peak = torch.cuda.max_memory_allocated(dev) - base
    busy = prof["device_ms"]
    adamw_ms = sum(v for k, v in prof["by_name"].items()
                   if "adamw" in k.lower()) / n_steps
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall, "first_call_ms": first_ms, "device_ms": busy,
            "busy_share": busy / wall if busy else None,
            "device_kernels": prof["device_kernels"],
            "host_launch_calls": prof["host_launch_calls"],
            "host_graph_launches": prof["host_graph_launches"],
            "host_copy_calls": prof["host_copy_calls"],
            "adamw_ms": adamw_ms,
            "adamw_share": adamw_ms / busy if busy else None,
            "peak_gib": peak / 2 ** 30,
            "top_ms_per_step": {k[:80]: v / n_steps for k, v in top}}


def compiled_vs_eager(torch, dev, model, init, batches, profile=False,
                      **kw):
    """The same train steps eager and compiled, each from ``init()``:
    {"bitwise", "max_rel" (of every leaf of the params and the optimizer
    state, relative to its max |eager|), "metric_rel", the compiled
    step's "graphs", "last_copies" and "launches" (by wrapper, over the
    compiled calls)}. With ``profile`` each run goes on after its checked
    calls with :func:`step_profile` (the same further calls on the last
    batch in both, so the states still compare), under "profile"."""
    from repro_torch.models import layers as L
    profiles = {}

    def run(compiled):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        state = init()
        box = {}

        def go():
            box["out"] = run_train_steps(torch, dev, model, state, batches,
                                         compiled, **kw)
        counts = counted(torch, go)
        metrics, first_ms, one = box["out"]
        if profile:
            profiles["compiled" if compiled else "eager"] = step_profile(
                torch, dev, one, first_ms, base)
        return state, metrics, one.step, counts
    eager, em, _, _ = run(False)
    comp, cm, step, counts = run(True)
    torch.cuda.synchronize()
    want = dict(L.tree_leaves(eager))
    bitwise, worst = True, 0.0
    for path, got in L.tree_leaves(comp):
        w = want[path]
        bitwise = bitwise and torch.equal(got, w)
        if got.is_floating_point():
            worst = max(worst, err(got, w) / max(w.abs().max().item(),
                                                 1e-30))
    metric_rel = max(abs(c[k] - e[k]) / max(abs(e[k]), 1e-30)
                     for c, e in zip(cm, em) for k in e)
    out = {"bitwise": bitwise and cm == em, "max_rel": worst,
           "metric_rel": metric_rel, "graphs": len(step.graphs),
           "last_copies": step.last_copies, "launches": counts,
           "losses": [m["loss"] for m in cm]}
    if profile:
        out["profile"] = profiles
    del eager, comp, step
    torch.cuda.empty_cache()
    return out


def report_train_profile(torch, card, profiles, model):
    """The ``train_profile`` line of full-width llama3.2-1b's train step
    (TRAIN's batch, AdamW's kernel), eager and compiled, from
    :func:`compiled_vs_eager`'s kernel pair; beside a bound: the
    products' 8 x params x tokens operations (forward, rematerialized
    forward, backward) at the bf16 peak, and AdamW's bytes (params, grads,
    both moments read; params and moments written; f32) at HBM's rate.
    The compiled step must launch one graph a step and no kernel outside
    it."""
    n = model.param_count()
    tokens = TRAIN["batch"] * TRAIN["seq"]
    ops_ms = 8 * n * tokens / PEAK_OPS_PER_S["bfloat16"] * 1e3
    opt_ms = 7 * 4 * n / HBM_BYTES_PER_S * 1e3
    c, e = profiles["compiled"], profiles["eager"]
    check("compiled train step: one graph launch a step and no kernel "
          "launched outside it",
          c["host_graph_launches"] == 1 and c["host_launch_calls"] == 1,
          f"graph launches {c['host_graph_launches']}, launch calls "
          f"{c['host_launch_calls']} a step; wall {c['wall_ms']:.1f} ms vs "
          f"eager {e['wall_ms']:.1f} ({card})")
    print("train_profile " + json.dumps({
        "card": card, "arch": TRAIN["arch"], "batch": TRAIN["batch"],
        "seq": TRAIN["seq"], "calls_before_profile": COMPILED_TRAIN_CALLS,
        **profiles,
        "bound_ms": {"products_at_bf16_peak": ops_ms,
                     "adamw_bytes_at_hbm": opt_ms}}), flush=True)


def check_compiled_train(torch, dev, card):
    """The compiled train step against the eager one (COMPILED_TRAIN_CALLS
    calls from one state): full-width llama3.2-1b with the plain AdamW
    and with the kernel (that pair profiled after its checked calls: the
    ``train_profile`` line), then TRAIN_SMALL's smoke models under AdamW
    and Adafactor."""
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.core.program import PipePolicy
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim import adafactor, adamw
    n = COMPILED_TRAIN_CALLS
    cfg = get_config(TRAIN["arch"]).replace(attn_impl="xla", scan_impl="xla")
    model = build_model(cfg)
    batches = [train_batch(torch, cfg, TRAIN["batch"], TRAIN["seq"], s)
               for s in range(n)]
    ocfg = adamw.AdamWConfig(lr_peak=TRAIN["lr"], warmup_steps=20,
                             total_steps=TRAIN["steps"])

    def init(model=model, optimizer="adamw"):
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        opt_init, _ = steps.opt_init_and_update(optimizer)
        return {"params": params, "opt": opt_init(params)}
    results = {}
    for impl, policy in (("plain", PipePolicy(mode="ref")), ("kernel", None)):
        r = compiled_vs_eager(torch, dev, model, init, batches,
                              profile=impl == "kernel", opt_cfg=ocfg,
                              policy=policy)
        if impl == "kernel":
            report_train_profile(torch, card, r.pop("profile"), model)
        results[f"{TRAIN['arch']} {impl}"] = r
        want = 2 * n if impl == "kernel" else 0
        check(f"train[{TRAIN['arch']}] compiled == eager bitwise, {impl} "
              f"AdamW: {n} calls (the capture's warm-up, then {n - 1} "
              f"replays) from one state"
              + (", then 7 more calls each (timed, profiled)"
                 if impl == "kernel" else "") + f" ({card})",
              r["bitwise"] and r["graphs"] == 1 and r["last_copies"] == 0
              and r["launches"].get("adamw", 0) == want,
              f"params and moments max rel diff {r['max_rel']:.3e}, "
              f"metrics {r['metric_rel']:.3e}; graphs {r['graphs']}, "
              f"last_copies {r['last_copies']}, launches {r['launches']} "
              f"(adamw {want} wanted); losses {r['losses']}")
    del model
    torch.cuda.empty_cache()
    for arch in TRAIN_SMALL:
        scfg = smoke_config(arch).replace(attn_impl="xla", scan_impl="xla")
        smodel = build_model(scfg)
        sb = [train_batch(torch, scfg, 2, 32, s) for s in range(n)]
        for optimizer, o in (("adamw", ocfg),
                             ("adafactor", adafactor.AdafactorConfig(
                                 lr_peak=TRAIN["lr"], warmup_steps=20,
                                 total_steps=TRAIN["steps"]))):
            r = compiled_vs_eager(
                torch, dev, smodel,
                lambda: init(smodel, optimizer), sb, optimizer=optimizer,
                opt_cfg=o)
            results[f"{arch} {optimizer}"] = r
            moe = arch in TRAIN_MOE
            ok = (r["graphs"] == 1 and r["last_copies"] == 0
                  and all(math.isfinite(x) for x in r["losses"])
                  and (max(r["metric_rel"], r["max_rel"]) <= TRAIN_MOE_TOL
                       if moe else r["bitwise"]))
            check(f"train smoke {arch} {optimizer} compiled vs eager "
                  f"({'MoE: within ' + str(TRAIN_MOE_TOL) + ' in every metric, parameter and state leaf' if moe else 'bitwise'})",
                  ok, f"bitwise {r['bitwise']}, params and state max rel "
                  f"diff {r['max_rel']:.3e}, metrics {r['metric_rel']:.3e}; "
                  f"graphs {r['graphs']}, launches {r['launches']}")
    # accumulation, captured as the unrolled loop it is (int8, the
    # trainer's --accum 2 --quantized-accum)
    scfg = smoke_config(TRAIN["arch"]).replace(attn_impl="xla",
                                               scan_impl="xla")
    smodel = build_model(scfg)
    r = compiled_vs_eager(
        torch, dev, smodel, lambda: init(smodel),
        [train_batch(torch, scfg, 4, 32, s) for s in range(n)],
        opt_cfg=ocfg, accum_steps=TRAIN["accum"], quantized_accum=True)
    results[f"{TRAIN['arch']} accum int8"] = r
    check(f"train smoke {TRAIN['arch']} --accum {TRAIN['accum']} "
          f"--quantized-accum compiled vs eager (bitwise)",
          r["bitwise"] and r["graphs"] == 1 and r["last_copies"] == 0,
          f"bitwise {r['bitwise']}, params and state max rel diff "
          f"{r['max_rel']:.3e}; graphs {r['graphs']}, launches "
          f"{r['launches']}")
    print("train_compiled " + json.dumps({
        k: {kk: v for kk, v in r.items() if kk != "losses"}
        for k, r in results.items()} | {"card": card}), flush=True)


def train_kill_resume(torch, tmp):
    """The reference's kill-and-resume gate on the card at smoke width,
    the trainer's step compiled (the resumed run captures its own graph):
    crash at step 12, resume to 20, against a clean 20 steps; every leaf
    of step 20's arrays.npz equal bit for bit."""
    import numpy as np
    from repro_torch.launch import train
    a, b = str(Path(tmp) / "crash"), str(Path(tmp) / "clean")
    kw = dict(KILL_RESUME)
    fail_at = kw.pop("fail_at")
    try:
        train.run(train_args(a, fail_at=fail_at, **kw))
        crashed = "no failure raised"
    except RuntimeError as e:
        crashed = str(e)
    r = train.run(train_args(a, **kw))
    train.run(train_args(b, **kw))
    za = np.load(Path(a) / "step_00000020" / "arrays.npz")
    zb = np.load(Path(b) / "step_00000020" / "arrays.npz")
    differ = [k for k in za.files if not np.array_equal(za[k], zb[k])]
    check("train kill-and-resume on the card (bitwise)",
          "injected failure at step 12" in crashed and r["start"] == 10
          and set(za.files) == set(zb.files) and not differ,
          f"{kw['arch']} smoke: crash '{crashed}', resumed from step "
          f"{r['start']}, {len(za.files)} leaves, differing: {differ[:5]}")


def train_guard(torch, dev):
    """A loss through the "ff" kernels with gradients on raises on the
    card, before any launch."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import build_model
    cfg = smoke_config("qwen1_5_0p5b").replace(attn_impl="ff")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch = tree_to(train_batch(torch, cfg, 2, 32), dev, torch)
    msg = "no error"

    def go():
        nonlocal msg
        try:
            value_and_grad(model, params, batch)
        except RuntimeError as e:
            msg = str(e)
    launches = counted(torch, go)
    check("train guard: a loss through the 'ff' kernels with grads raises",
          "no backward kernel" in msg and not launches,
          f"{msg[:90]!r}; launches {launches}")


def train_lr_sweep(torch, dev):
    """Full-width llama3.2-1b for TRAIN's steps at each of TRAIN_LRS
    through ``make_train_step`` (AdamW, 20 warm-up steps, the trainer's
    batches, no checkpoint): the first and last five losses' means (a
    ``train_lr`` line)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    cfg = get_config(TRAIN["arch"]).replace(attn_impl="xla", scan_impl="xla")
    model = build_model(cfg)
    out = {"card": smi_line(), "arch": TRAIN["arch"], "lr": {}}
    for lr in TRAIN_LRS:
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        ocfg = adamw.AdamWConfig(lr_peak=lr, warmup_steps=20,
                                 total_steps=TRAIN["steps"])
        state = adamw.init(params)
        step = steps.make_train_step(model, opt_cfg=ocfg, compiled=False)
        losses = []
        for s in range(TRAIN["steps"]):
            batch = tree_to(train_batch(torch, cfg, TRAIN["batch"],
                                        TRAIN["seq"], s), dev, torch)
            losses.append(step(params, state, batch)[2]["loss"].item())
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        out["lr"][str(lr)] = {"first5": first, "last5": last,
                              "margin": first - last, "losses": losses}
        del params, state
        torch.cuda.empty_cache()
    print("train_lr " + json.dumps(out), flush=True)


def train_phase(torch, dev):
    """Phase i: the smoke models' training card vs CPU, full-width
    llama3.2-1b through the trainer (its step compiled), the compiled step
    against the eager one, the profile of both, kill-and-resume, the "ff"
    guard. Returns the trainer runs' launches by wrapper."""
    import tempfile
    t0 = time.perf_counter()
    card = smi_line()
    check_train_small(torch, dev, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        launches = train_full(torch, dev, card, tmp)
        want = 2 * (TRAIN["steps"] + TRAIN["accum_steps"])
        check("train path launches the AdamW kernel alone, twice a step "
              "(the model on the 'xla' path, as the reference)",
              launches["adamw"] == want
              and not any(v for k, v in launches.items() if k != "adamw"),
              f"{launches} (adamw {want} wanted)")
        check_compiled_train(torch, dev, card)
        train_kill_resume(torch, tmp)
    train_guard(torch, dev)
    # the supervisor's counters live in the process-wide registry: drop
    # them, so the serve runs after this phase report a serve process's
    # metrics, as phase h requires
    from repro_torch import obs
    obs.metrics_clear("supervisor_")
    print(f"i. train: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# j. the distributed runtime (several ranks on the one card)
# ---------------------------------------------------------------------------


def _j_rank_setup():
    """A rank's card (every rank shares card 0) and the kernels' launch
    counts zeroed."""
    import torch
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for w in wrappers().values():
        w.launches = 0
    return torch, torch.device("cuda", 0)


def j_probe(rank, world, ops):
    """Each of ``ops`` once on CUDA tensors over the group, in order:
    {op: "ok" | "wrong" | the error}. A collective gloo cannot take may
    kill the process (gloo hands a device pointer to its TCP transport),
    so each risky op runs in a group of its own."""
    import torch.distributed as dist
    torch, dev = _j_rank_setup()
    x = torch.full((8, 4), float(rank + 1), device=dev)
    total = float(sum(range(1, world + 1)))
    out = {}
    for op in ops:
        try:
            if op == "all_reduce":
                y = x.clone()
                dist.all_reduce(y)
                ok = bool((y == total).all())
            elif op == "broadcast":
                y = x.clone()
                dist.broadcast(y, 0)
                ok = bool((y == 1).all())
            elif op == "all_gather_into_tensor":
                y = torch.empty(8 * world, 4, device=dev)
                dist.all_gather_into_tensor(y, x)
                ok = all(bool((y[8 * r:8 * r + 8] == r + 1).all())
                         for r in range(world))
            elif op == "reduce_scatter_tensor":
                y = torch.empty(8 // world, 4, device=dev)
                dist.reduce_scatter_tensor(y, x)
                ok = bool((y == total).all())
            elif op == "all_to_all_single":
                y = torch.empty_like(x)
                dist.all_to_all_single(y, x)
                step = 8 // world
                ok = all(bool((y[step * r:step * r + step] == r + 1).all())
                         for r in range(world))
            elif op == "batch_isend_irecv":
                y = torch.empty_like(x)
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, (rank + 1) % world),
                    dist.P2POp(dist.irecv, y, (rank - 1) % world)])
                for r in reqs:
                    r.wait()
                ok = bool((y == (rank - 1) % world + 1).all())
            elif op == "send_recv":
                y = torch.empty_like(x)
                if rank % 2 == 0:
                    dist.send(x, rank + 1)
                    ok = True
                else:
                    dist.recv(y, rank - 1)
                    ok = bool((y == rank).all())
            torch.cuda.synchronize()
            out[op] = "ok" if ok else "wrong"
        except RuntimeError as e:
            out[op] = f"{type(e).__name__}: {str(e)[:120]}"
    return out


def dist_probe(tmp):
    """Which collectives the runtime and DTensor issue work on CUDA
    tensors over DIST["ranks"] gloo ranks on the card, and the point-to-
    point pair again under ``gloo_staged``: {"<backend> <op>": result}.
    The groups run side by side; a group whose process died reports its
    ops as crashed."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import spawn_ranks
    groups = [("gloo", DIST_PROBE[:5]), ("gloo", ("batch_isend_irecv",)),
              ("gloo", ("send_recv",)),
              ("gloo_staged", ("batch_isend_irecv", "send_recv"))]

    def run(i):
        backend, ops = groups[i]
        try:
            res = spawn_ranks(j_probe, DIST["ranks"], (ops,),
                              init_file=f"{tmp}/probe{i}", backend=backend,
                              timeout=DIST["probe_timeout"])
            merged = {op: (res[0][op] if all(r[op] == res[0][op]
                                             for r in res)
                           else [r[op] for r in res]) for op in ops}
        except RuntimeError as e:
            why = "process died" if "gave no result" in str(e) else "raised"
            merged = {op: f"crashed ({why})" for op in ops}
        return {f"{backend} {op}": v for op, v in merged.items()}

    out = {}
    with ThreadPoolExecutor(len(groups)) as pool:
        for res in pool.map(run, range(len(groups))):
            out.update(res)
    return out


def j_sharded_smoke():
    """Every registry kernel with shard_dims over a 4-way "data" mesh on
    the card, held against its unsharded call."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.registry import all_kernels, run_sharded_smoke
    mesh = init_device_mesh("cuda", (DIST["ranks"],),
                            mesh_dim_names=("data",))
    out = {}
    for spec in all_kernels():
        if spec.shard_dims is None:
            continue
        sh, un, rf, err_un, err_ref = run_sharded_smoke(spec, mesh)
        out[spec.name] = {"bitwise": bool((sh == un).all()),
                          "err_unsharded": err_un, "err_plain": err_ref,
                          "tol": spec.tol}
    return out


def j_collectives():
    """allgather_matmul and matmul_reducescatter with a policy at
    llama3.2-1b's widths ([m, k] @ [k, n], bf16) over the host mesh's
    "model" axis: (outputs against torch.matmul of the gathered operands,
    ff_matmul launches inside each, wall ms a call)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.program import PipePolicy
    from repro_torch.kernels.ff_matmul import matmul
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import sharding as shlib
    from repro_torch.runtime.collectives import (allgather_matmul,
                                                 matmul_reducescatter)
    dev = torch.device("cuda", 0)
    m, k, n = DIST["collective"]
    gen = torch.Generator(device=dev).manual_seed(11)
    x, w = matmul_operands(torch, dev, gen, m, k, n, torch.bfloat16)
    want = torch.matmul(x.float(), w.float())
    mesh = make_host_mesh(device_type="cuda")
    n_model = mesh.size(1)
    idx = mesh.get_local_rank("model")
    pol = PipePolicy()
    out = {}
    with shlib.use_sharding(mesh):
        rows = m // n_model
        for name, fn in (
                ("allgather_matmul", lambda: allgather_matmul(
                    x[idx * rows:(idx + 1) * rows], w, "model", policy=pol)),
                ("matmul_reducescatter", lambda: matmul_reducescatter(
                    x[:, idx * (k // n_model):(idx + 1) * (k // n_model)],
                    w[idx * (k // n_model):(idx + 1) * (k // n_model)],
                    "model", policy=pol))):
            matmul.launches = 0
            got = fn()
            torch.cuda.synchronize()
            launches = matmul.launches
            ref = want if name == "allgather_matmul" else \
                want[idx * rows:(idx + 1) * rows]
            ok, e = within(got, ref, BF16_TOL)
            times = []
            for _ in range(DIST["collective_reps"]):
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[name] = {"ok": ok, "max_abs_err": e, "launches": launches,
                         "wall_ms": sorted(times)[len(times) // 2],
                         "hops": n_model - 1,
                         "hop_bytes": (rows * k if name == "allgather_matmul"
                                       else rows * n) * 2}
    return out


def j_four(rank, world, ckpt_dir):
    """Phase j's 4-rank spawn on the card (gloo_staged): the sharded smoke
    of every registry kernel, the collectives at full width, and a smoke
    llama3.2-1b checkpoint written from the (2, 2) mesh for the remesh."""
    torch, dev = _j_rank_setup()
    from repro_torch.checkpoint import save
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import sharding as shlib
    out = {"smoke": j_sharded_smoke(),
           "collectives": j_collectives()}
    cfg = smoke_config(DIST["arch"])
    model = build_model(cfg)
    with shlib.use_sharding(make_host_mesh(device_type="cuda"),
                            overrides=cfg.rule_overrides):
        params = steps_lib.init_params(
            model, torch.Generator(device=dev).manual_seed(0), dev)
        save(ckpt_dir, 7, params)
    return out if rank == 0 else None


def j_nccl(rank, world):
    """NCCL at world size 1 (the only NCCL world one card allows): an
    all-reduce, then one AdamW step of smoke llama3.2-1b on DTensor state
    over the (1, 1) host mesh against the same step on plain tensors."""
    import torch.distributed as dist
    torch, dev = _j_rank_setup()
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shlib
    x = torch.full((4,), 3.0, device=dev)
    dist.all_reduce(x)
    cfg = smoke_config(DIST["arch"]).replace(attn_impl="xla")
    model = build_model(cfg)
    batch = train_batch(torch, cfg, 8, 32)
    losses = []
    for mesh in (None, make_host_mesh(device_type="cuda")):
        ctx = (shlib.use_sharding(mesh, overrides=cfg.rule_overrides)
               if mesh is not None else contextlib.nullcontext())
        with ctx:
            params = steps_lib.init_params(
                model, torch.Generator(device=dev).manual_seed(0), dev)
            b = shlib.place_tree({k: v.to(dev) for k, v in batch.items()},
                                 {k: ("batch", "seq") for k in batch})
            step = steps_lib.make_train_step(
                model, opt_cfg=adamw.AdamWConfig(warmup_steps=1),
                compiled=False)
            _, _, m = step(params, adamw.init(params), b)
            losses.append(float(m["loss"]))
    return {"all_reduce": x.tolist(), "loss_plain": losses[0],
            "loss_mesh": losses[1], "backend": dist.get_backend()}


def j_two(rank, world, ckpt_dir):
    """Phase j's 2-rank spawn on the card: the smoke checkpoint restored
    onto survivable_mesh of the 2 ranks (model axis kept at 2), and
    full-width llama3.2-1b's 16 layers as a 2-stage GPipe of
    DIST["pipe_micro"] microbatches against the same layers in sequence
    (under no_grad)."""
    torch, dev = _j_rank_setup()
    import numpy as np

    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.kernels.ff_attention import attention
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.runtime import elastic
    from repro_torch.runtime import sharding as shlib
    from repro_torch.runtime.pipeline_parallel import pipeline_apply
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    # -- remesh 4 -> 2
    smoke = build_model(smoke_config(DIST["arch"]))
    mesh = elastic.survivable_mesh(range(world), model_axis=2,
                                   device_type="cuda")
    state, step = elastic.remesh_restore(
        ckpt_dir, smoke.abstract_params(), smoke.param_axes(), mesh,
        overrides=smoke.cfg.rule_overrides)
    full = {"/".join(p): shlib.full_tensor(t).cpu().numpy()
            for p, t in L.tree_leaves(state)}
    with np.load(f"{ckpt_dir}/step_{step:08d}/arrays.npz") as ck:
        bitwise = all(np.array_equal(full[k], ck[k]) for k in ck.files) \
            and set(full) == set(ck.files)
    rep = elastic.last_remesh()
    out["remesh"] = {"bitwise": bitwise, "step": step, "mesh": rep.mesh.token,
                     "placements": sorted({str(t.placements) for _, t in
                                           L.tree_leaves(state)})}
    del state, full
    # -- GPipe of the 16 full-width layers over 2 stages
    cfg = get_config(DIST["arch"])
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init_cast(gen, dev)
    layers = L.unstack(params["stack"]["layers"], cfg.n_layers)
    per = cfg.n_layers // world
    mine = layers[rank * per:(rank + 1) * per]
    b, s = DIST["pipe_mb"], DIST["pipe_seq"]
    tok = torch.randint(0, cfg.vocab, (DIST["pipe_micro"], b, s),
                        generator=gen, device=dev)
    micro = L.embed_lookup(params["embed"], tok, cfg.cdtype)
    positions = torch.arange(s, device=dev)

    def stage(ps, x):
        for p in ps:
            x, _, _ = model.stack._layer(p, x, positions, None, None,
                                         want_cache=False)
        return x

    pipe_mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("pod",))
    with torch.no_grad():
        attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = pipeline_apply(stage, mine, micro, "pod", mesh=pipe_mesh)
        torch.cuda.synchronize()
        pipe_ms = (time.perf_counter() - t0) * 1e3
        launches = attention.launches
        t0 = time.perf_counter()
        want = torch.stack([stage(layers, x) for x in micro])
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t0) * 1e3
    if rank == world - 1:
        ok, e = within(outs, want, BF16_TOL)
        out["pipeline"] = {"bitwise": bool(torch.equal(outs, want)),
                           "ok": ok, "max_abs_err": e,
                           "ff_attention_launches": launches,
                           "pipe_ms": pipe_ms, "sequential_ms": seq_ms}
    gathered = [None] * world
    torch.distributed.all_gather_object(gathered, out)
    if rank:
        return None
    return {"remesh": out["remesh"], "pipeline": gathered[-1]["pipeline"]}


def train_cmd(nproc, ckpt_dir):
    """The trainer's command line at DIST's settings, writing no
    checkpoint (phase i's trainer writes the run's one full-width
    checkpoint): one process, or ``nproc`` ranks under torchrun on the one
    card (gloo_staged: gloo's collectives, counted)."""
    args = ["-m", "repro_torch.launch.train", "--arch", DIST["arch"],
            "--steps", str(DIST["steps"]), "--batch", str(DIST["batch"]),
            "--seq", str(DIST["seq"]), "--lr", str(DIST["lr"]),
            "--log-every", "1", "--ckpt-dir", ckpt_dir, "--ckpt-every",
            "0"]
    if nproc == 1:
        return [sys.executable] + args
    return ([sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(nproc)] + args
            + ["--mesh", "host", "--dist-backend", "gloo_staged"])


def run_train(nproc, ckpt_dir):
    """Run the trainer as :func:`train_cmd` says; its ``# train_result``
    JSON, with the command's wall seconds."""
    import os
    # 4 ranks' ~16 GiB peaks fill the card but for their segments' slack
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    t0 = time.perf_counter()
    r = subprocess.run(train_cmd(nproc, ckpt_dir), env=env,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith("# train_result ")]
    if r.returncode or not lines:
        # rank 0's own lines (torchrun prefixes them), not DTensor's warnings
        err = [ln for ln in r.stderr.splitlines()
               if ln.startswith("[rank0]") or "Error" in ln]
        raise RuntimeError(f"trainer ({nproc} rank(s)) exited "
                           f"{r.returncode}:\n{r.stdout[-3000:]}\n"
                           + "\n".join(err[-60:]))
    return {**json.loads(lines[-1][len("# train_result "):]),
            "wall_s": wall}


def expected_param_bytes(cfg, mesh_shape):
    """Bytes of f32 parameters one rank holds on ``mesh_shape`` by the
    config's rules (each sharded dim divided by its mesh axes' sizes)."""
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.runtime import sharding as shlib
    rules = shlib.prune_rules({**shlib.DEFAULT_RULES,
                               **(cfg.rule_overrides or {})}, mesh_shape)
    total = 0
    for _, spec in L.tree_leaves(build_model(cfg).param_specs()):
        n = 1
        for size, axis in zip(spec.shape, spec.axes):
            target = rules.get(axis) if axis else None
            split = 1
            for a in ((target,) if isinstance(target, str) else
                      target or ()):
                split *= mesh_shape[a]
            n *= size // split
        total += n * 4
    return total


def dist_phase(torch, dev):
    """Phase j: the gloo-on-CUDA probe; the 4-rank spawn (sharded smoke,
    the collectives at full width, the remesh checkpoint); NCCL at world
    size 1; the 2-rank spawn (remesh restore, the 16-layer GPipe);
    full-width llama3.2-1b trained by launch/train.py on 1 rank and then
    4. This process makes no CUDA context of its own before the ranks
    run (they need the whole card). Returns the dist paths' launches of
    each kernel wrapper."""
    import tempfile

    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    card = smi_line()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        probe = dist_probe(tmp)
        print("dist_probe " + json.dumps(probe), flush=True)
        need = [f"gloo {op}" for op in DIST_PROBE[:4]] + [
            "gloo_staged batch_isend_irecv", "gloo_staged send_recv"]
        check("gloo on CUDA: every collective the runtime and DTensor "
              "issue works (point-to-point through gloo_staged)",
              all(probe[k] == "ok" for k in need),
              "; ".join(f"{k}: {probe[k]}" for k in need))
        t1 = time.perf_counter()
        four = spawn_ranks(j_four, DIST["ranks"], (f"{tmp}/remesh",),
                           init_file=f"{tmp}/four", backend="gloo_staged",
                           timeout=300)[0]
        for name, r in four["smoke"].items():
            why = "" if r["bitwise"] else (
                "; not bitwise: " + SHARD_NOT_BITWISE.get(
                    name, "no reason known"))
            check(f"sharded smoke {name} over data={DIST['ranks']} on the "
                  f"card", r["bitwise"] or (
                      r["err_unsharded"] <= r["tol"]
                      and name in SHARD_NOT_BITWISE),
                  f"max |sharded - unsharded| {r['err_unsharded']:.3e}, "
                  f"vs plain {r['err_plain']:.3e} (tol {r['tol']}){why}")
        for name, r in four["collectives"].items():
            check(f"{name} with a policy at {DIST['collective']} bf16 over "
                  f"model=2 == torch.matmul of the gathered operands",
                  r["ok"] and r["launches"] > 0,
                  f"max abs err {r['max_abs_err']:.3e} (tol {BF16_TOL}); "
                  f"ff_matmul launches {r['launches']}")
        launches["ff_matmul"] = {
            f"dist[{n}]": r["launches"]
            for n, r in four["collectives"].items()}
        nccl = spawn_ranks(j_nccl, 1, init_file=f"{tmp}/nccl",
                           backend="nccl", timeout=300)[0]
        check("NCCL at world size 1: all_reduce, and a smoke llama3.2-1b "
              "step on DTensor state over the (1, 1) mesh == on plain "
              "tensors", nccl["all_reduce"] == [3.0] * 4
              and abs(nccl["loss_mesh"] - nccl["loss_plain"])
              <= 1e-6 * abs(nccl["loss_plain"]), json.dumps(nccl))
        two = spawn_ranks(j_two, 2, (f"{tmp}/remesh",),
                          init_file=f"{tmp}/two", backend="gloo_staged",
                          timeout=300)[0]
        check("remesh 4 ranks -> 2 (smoke llama3.2-1b) bit for bit",
              two["remesh"]["bitwise"], json.dumps(two["remesh"]))
        p = two["pipeline"]
        check(f"pipeline_apply: {get_config(DIST['arch']).n_layers} "
              f"full-width layers, 2 stages x {DIST['pipe_micro']} "
              f"microbatches == sequential", p["ok"],
              f"bitwise {p['bitwise']}, max abs err {p['max_abs_err']:.3e};"
              f" ff_attention launches {p['ff_attention_launches']}")
        launches["ff_attention"] = {
            "dist[pipeline_apply]": p["ff_attention_launches"]}
        spawn_s = time.perf_counter() - t1
        # -- full-width training: 1 rank, then 4 on the one card
        t1 = time.perf_counter()
        one = run_train(1, f"{tmp}/train1")
        shutil.rmtree(f"{tmp}/train1", ignore_errors=True)
        many = run_train(DIST["ranks"], f"{tmp}/train4")
        shutil.rmtree(f"{tmp}/train4", ignore_errors=True)
        train_s = time.perf_counter() - t1
    rel = [abs(a - b) / abs(b) for a, b in zip(many["loss"], one["loss"])]
    margins = [DIST["loss_tol"][min(i, 1)] - r for i, r in enumerate(rel)]
    check(f"train[{DIST['arch']}] full width on {DIST['ranks']} ranks "
          f"{many['mesh']} vs 1 rank: step-1 loss within "
          f"{DIST['loss_tol'][0]} relative, later steps within "
          f"{DIST['loss_tol'][1]}",
          len(rel) == DIST["steps"] and all(m >= 0 for m in margins),
          f"relative diffs {rel}, margins {margins}")
    cfg = get_config(DIST["arch"])
    want = expected_param_bytes(cfg, many["mesh"])
    got = [r["param_bytes"] for r in many["ranks"]]
    check("each rank holds its parameters as the rules say",
          got == [want] * DIST["ranks"],
          f"{got} bytes, rules {want} (1 rank: "
          f"{one['ranks'][0]['param_bytes']})")
    want_adamw = 2 * DIST["steps"]
    adamw_n = [r["kernel_launches"].get("adamw", 0)
               for r in one["ranks"] + many["ranks"]]
    check(f"the trainer on 1 rank and on each of {DIST['ranks']} ranks "
          f"launches the AdamW kernel twice a step (on a mesh on the "
          f"rank's shards) and no other kernel of the port",
          adamw_n == [want_adamw] * (1 + DIST["ranks"])
          and all(set(r["kernel_launches"]) <= {"adamw"}
                  for r in one["ranks"] + many["ranks"]),
          f"1 rank {one['ranks'][0]['kernel_launches']}, "
          f"{DIST['ranks']} ranks "
          f"{[r['kernel_launches'] for r in many['ranks']]} "
          f"(adamw {want_adamw} wanted)")
    launches["adamw"] = {
        "dist[train 1 rank]": adamw_n[0],
        **{f"dist[train {DIST['ranks']} ranks, rank {i}]": n
           for i, n in enumerate(adamw_n[1:])}}
    peak1 = one["ranks"][0]["peak_bytes"]
    peaks = [r["peak_bytes"] for r in many["ranks"]]
    check(f"each rank's peak below {DIST['peak_frac']} x the 1-rank peak",
          all(p < DIST["peak_frac"] * peak1 for p in peaks),
          f"{[round(p / 2 ** 30, 2) for p in peaks]} GiB vs "
          f"{peak1 / 2 ** 30:.2f} GiB")
    tokens = DIST["batch"] * DIST["seq"]

    def med(xs):
        xs = sorted(xs[1:])
        return xs[len(xs) // 2]

    print("dist " + json.dumps({
        "arch": DIST["arch"], "batch": DIST["batch"], "seq": DIST["seq"],
        "steps": DIST["steps"], "mesh": many["mesh"],
        "loss_1": one["loss"], "loss_n": many["loss"], "rel_diff": rel,
        "step_ms_1": one["step_ms"], "step_ms_n": many["step_ms"],
        "tokens_per_s_1": tokens / med(one["step_ms"]) * 1e3,
        "tokens_per_s_n": tokens / med(many["step_ms"]) * 1e3,
        "peak_gib_1": peak1 / 2 ** 30,
        "peak_gib_n": [p / 2 ** 30 for p in peaks],
        "param_bytes_n": got,
        "comm_bytes_per_step_n": [r["comm_bytes"] for r in many["ranks"]],
        "train_wall_s": [one["wall_s"], many["wall_s"]],
        "collectives": four["collectives"], "pipeline": p,
        "sharded_smoke": four["smoke"], "spawn_s": spawn_s,
        "train_s": train_s, "card": card,
        "note": "ranks share one card; every hop is host-staged gloo"}),
        flush=True)
    print(f"j. distributed: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches

# ---------------------------------------------------------------------------
# k. the chaos harness, the examples, the feed-forward specs, the dry run
# ---------------------------------------------------------------------------

# the examples with their arguments on the card and the line each must end
# with (the reference's last line; the port's trainer adds its result and
# checkpoint lines, starting "# ", after it)
EXAMPLES = (
    ("quickstart", (), r"^quickstart done$"),
    # cut from the example's 300 steps to 30 (~3 s of steps on the card)
    ("train_tiny_lm", ("--steps", "30"),
     r"^done at step 30; median step \d+ ms$"),
    ("serve_pipelined", (),
     r"^speedup x[\d.]+ tok/s, p99 x[\d.]+, bitwise diff 0\.0e\+00$"),
    ("microbench_sweep", (), r"^ chunk_scan\[ff\] max\|err\| = "),
)
# the dry run's full-width cell
DRY_CELL = ("qwen1_5_0p5b", "train_4k")


def _sub_env():
    import os
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}


def chaos_check(tmp):
    """``python -m repro_torch.runtime.chaos suite --device cuda``: every
    scenario ``ok``, and every worker's report counts ff_matmul launches
    (the state update's product ran as the kernel)."""
    out = f"{tmp}/chaos.json"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.runtime.chaos",
                        "suite", "--device", "cuda", "--workdir",
                        f"{tmp}/chaos", "--json", out], env=_sub_env(),
                       capture_output=True, text=True, timeout=900,
                       cwd=str(ROOT))
    wall = time.perf_counter() - t0
    if r.returncode != 0 and not Path(out).exists():
        check("chaos suite --device cuda ran", False,
              f"rc {r.returncode}: {r.stderr[-3000:]}")
        return
    suite = json.loads(Path(out).read_text())
    for name, sc in suite["scenarios"].items():
        launches = sc.get("ff_matmul_launches")
        counts = (list(launches.values()) if isinstance(launches, dict)
                  else [launches])
        check(f"chaos {name} ok on the card", bool(sc.get("ok")),
              json.dumps({k: v for k, v in sc.items()
                          if k not in ("mitigations", "stderr")})
              + (f" stderr: {sc['stderr'][-1500:]}" if "stderr" in sc
                 else ""))
        check(f"chaos {name}: ff_matmul launched in every worker",
              all(isinstance(c, int) and c > 0 for c in counts),
              f"ff_matmul launches {launches}")
    print("chaos " + json.dumps({
        "wall_s": wall, "suite_wall_s": suite["wall_s"],
        "scenarios": {k: {f: v[f] for f in (
            "ok", "recovery_s", "restart_wall_s", "wall_s",
            "ff_matmul_launches", "bitwise_identical", "prewarmed",
            "restart_plan_stats", "post_remesh_stats", "save_count")
            if f in v} for k, v in suite["scenarios"].items()}}),
        flush=True)


def examples_check(tmp):
    """Each ``examples/*_torch.py`` on the card (the four at the same
    time: most of each one's wall is starting torch and the card),
    required to exit 0 and to reach its reference's last line."""
    import re
    procs = {}
    t0 = time.perf_counter()
    for name, extra, _ in EXAMPLES:
        args = list(extra)
        if name == "train_tiny_lm":
            args += ["--ckpt-dir", f"{tmp}/tiny_lm"]
        procs[name] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
             *args], env=_sub_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=str(ROOT))
    walls = {}
    try:
        for name, _, last in EXAMPLES:
            out, errs = procs[name].communicate(timeout=600)
            walls[name] = time.perf_counter() - t0
            rc = procs[name].returncode
            ours = [ln for ln in out.splitlines()
                    if ln.strip() and not ln.startswith("# ")]
            ok = rc == 0 and bool(ours) and bool(re.match(last, ours[-1]))
            check(f"example {name}_torch.py on the card reaches its last "
                  f"line", ok, (ours[-1] if ours else "no output")
                  + f" ({walls[name]:.1f} s)"
                  + ("" if ok else f"; rc {rc}: {errs[-2000:]}"))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    print("examples " + json.dumps({"wall_s": walls}), flush=True)


def feedforward_check(torch, dev):
    """The core/feedforward specs against the kernels on the card: the
    k-tiled product spec against ``ops.matmul`` (ff_matmul: f32, and bf16
    on the ring), the row-gather spec against ``ops.gather`` (ff_gather),
    each launched (counts zeroed before). f32 within 5e-4 (the registry's
    ff_matmul tolerance: the spec sums k a tile at a time), bf16 within
    2e-2, the gather exactly."""
    from repro_torch import ops
    from repro_torch.core import feedforward as ff
    from repro_torch.kernels.ff_gather import gather
    from repro_torch.kernels.ff_matmul import matmul
    gen = torch.Generator(device=dev).manual_seed(13)
    m, k, n, tk = 64, 1024, 512, 128
    for dtype, tol in ((torch.float32, LIB_F32_TOL),
                       (torch.bfloat16, BF16_TOL)):
        a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        b = (torch.randn(k, n, generator=gen, device=dev)
             / k ** 0.5).to(dtype)
        spec = ff.ktiled_product_spec(m, k, n, tk, device=dev)
        want = ff.run_reference(spec, (a, b))
        matmul.launches = 0
        got = ops.matmul(a, b)
        torch.cuda.synchronize()
        ok, e = within(got, want, tol)
        check(f"ff_matmul {str(dtype)[6:]} [{m},{k}]@[{k},{n}] vs the "
              f"k-tiled StreamSpec ({k // tk} words)",
              ok and matmul.launches == 1,
              f"max err {e:.3e} tol {tol}; launches {matmul.launches}")
    table = torch.randn(4096, 256, generator=gen, device=dev)
    idx = torch.randint(0, 4096, (1000,), generator=gen,
                        device=dev).to(torch.int32)
    spec = ff.row_gather_spec(1000, 256, 64, device=dev)
    want = ff.run_reference(spec, (table, idx))
    gather.launches = 0
    got = ops.gather(table, idx)
    torch.cuda.synchronize()
    check("ff_gather table[4096,256] idx[1000] vs the row-gather StreamSpec "
          "(16 words) exactly", torch.equal(got, want)
          and gather.launches == 1, f"launches {gather.launches}")


def start_dryrun(tmp):
    """Start ``python -m repro_torch.launch.dryrun`` of one full-width cell
    on a 256-rank fake group (host work only: it runs beside the rest of
    phase k). Returns (process, start time)."""
    arch, shape = DRY_CELL
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", f"{tmp}/dryrun"], env=_sub_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT)), time.perf_counter()


def dryrun_check(tmp, started):
    """The dry run's result (:func:`start_dryrun`), then its roofline row
    (``launch/roofline.py``)."""
    arch, shape = DRY_CELL
    out_dir = f"{tmp}/dryrun"
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    r = Namespace(returncode=proc.returncode, stdout=stdout, stderr=stderr)
    cell = Path(out_dir) / f"{arch}__{shape}__pod16x16.json"
    result = json.loads(cell.read_text()) if cell.exists() else {}
    check(f"dryrun {arch} x {shape} x pod16x16 (256 fake ranks)",
          r.returncode == 0 and bool(result.get("ok")),
          f"rc {r.returncode}, wall {wall:.1f} s: {r.stdout[-500:]}"
          f"{result.get('error', '')}{r.stderr[-1500:]}")
    if not result.get("ok"):
        return
    from repro_torch.launch import roofline
    row = roofline.analyze_cell(result)
    print("dryrun " + json.dumps({
        "cell": result["cell"], "wall_s": wall,
        "timings": result.get("timings"), "memory": result["memory"],
        "cost_scan_program": result["cost_scan_program"],
        "variants": result["variants"], "roofline": row,
        "n_params": result["n_params"]}), flush=True)
    print(roofline.markdown_table([row]), flush=True)


# phase l: the graphs at full width, the mesh, the dry-run cells
GRAPH_QWEN = dict(b=4, d=1024, h=16, kvh=16, hd=64, f=2816, s=256)
# the device symbol each fused launch profiles as (ff_layer.cu's ring
# kernels are templates, ring_mlp_tail_kernel<T> in both types)
GRAPH_KERNEL_SYMBOL = {"ff_dispatch_matmul": "wgmma_kernel",
                       "ff_attention_proj": "attention_proj_wg_kernel",
                       "ff_paged_decode_attention": "ring_decode_kernel",
                       "ff_layer_mlp_tail": "ring_mlp_tail_kernel"}
GRAPH_PROFILE_TRIES = 3
MESH_SERVE = dict(arch="qwen1_5_0p5b", batch=4, prompt=256, steps=8,
                  tol=1e-3, ranks=4)
MESH_TRAIN = dict(arch="grok1_314b", batch=8, seq=32, steps=3, tol=1e-3)
# launch/serve.py under torchrun on 4 ranks of the card as (data 2, model
# 2): full-width qwen1.5-0.5B (24 layers, bf16 as served), against the same
# arguments on 1 rank; --layer-graph, cut to lg_layers layers, is served
# by serve_bench inside phase l's spawn of 4 ranks (each rank runs the
# decode-layer kernels on gathered weights, ~20 MB a layer a step through
# the host)
MESH_CLI = dict(ranks=4, backend="gloo_staged", timeout=600, lg_layers=4,
                args=dict(requests=8, prompt_len=32, max_new=8, slots=4,
                          page=16, rate=0.0))
MESH_CLI_ROWS = {"ff_attention": "ff_attention",
                 "ff_decode_attention": "ff_decode_attention",
                 "ff_paged_decode_attention": "paged_decode_attention",
                 "ff_layer_matmul": "ff_layer_matmul",
                 "ff_layer_mlp_tail": "ff_layer_mlp_tail"}
L_DRY_CELLS = (("qwen1_5_0p5b", "prefill_32k"), ("qwen1_5_0p5b", "decode_32k"),
               ("grok1_314b", "train_4k"))
L_HILLCLIMB = ("--cell", "qwen1_5_0p5b:prefill_32k", "--tag", "l_f32",
               "--patch", "compute_dtype=float32")


def graph_cases(torch, dev):
    """(label, spec, op args, op keywords) of phase l's graphs: each
    registered graph at its registered shapes in bf16, and the decode
    layer at full-width qwen1.5-0.5B's widths (RoPE theta 1e6)."""
    from repro_torch.kernels import registry as R
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.runtime import paged_kv as P
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(17)
    make = {"attention_proj": L._attention_proj_inputs,
            "moe_dispatch_ffn": M._moe_graph_inputs,
            "paged_decode_attention": P._graph_inputs,
            "decode_layer": lambda g, d, **kw: L._decode_layer_inputs(
                g, d, **kw)[0]}
    cases = [(name, R.get_graph(name), make[name](gen, dev, dtype=bf), {})
             for name in R.graph_names()]
    q = GRAPH_QWEN
    args = L._decode_layer_inputs(gen, dev, b=q["b"], d=q["d"], h=q["h"],
                                  kvh=q["kvh"], hd=q["hd"], f=q["f"],
                                  s=q["s"], dtype=bf)[0]
    cases.append(("decode_layer[qwen1.5-0.5B]", R.get_graph("decode_layer"),
                  args, {"rope_theta": 1e6}))
    return cases


def graph_device_launches(torch, fn, fused_units, counts):
    """Each fused chain's kernel as the profiler counts it on the device
    over one call of ``fn`` (``profile_window``), and the windows that saw
    fewer of them than the wrappers launched (``counts``): the profiler
    lost device events there, so the window is traced again, at most
    GRAPH_PROFILE_TRIES windows in all, as ``profile_steps`` does. A
    window that sees more launches than the wrappers made is kept."""
    lost = []
    for _ in range(GRAPH_PROFILE_TRIES):
        kern = profile_window(torch, fn, 1)["count"]
        seen = {f: sum(c for n, c in kern.items()
                       if GRAPH_KERNEL_SYMBOL[f] in n) for f in fused_units}
        if all(seen[f] >= counts.get(f, 0) for f in fused_units):
            break
        lost.append(seen)
    return seen, lost


def check_graphs(torch, dev):
    """Phase l's graphs: each case compiled fused and staged; fused ==
    ``spec.op`` and staged == ``spec.unfused`` bit for bit, one launch of
    each fused chain's kernel (by its wrapper and by the profiler)."""
    from repro_torch.kernels import registry as R
    for label, spec, args, kw in graph_cases(torch, dev):
        cg, operands, view = R.compile_spec(spec, args, **kw)
        fused_units = [u.launch for u in cg.units if u.kind == "fused"]
        counts = counted(torch, lambda: cg(*operands))
        on_device, lost = graph_device_launches(
            torch, lambda: cg(*operands), fused_units, counts)
        out = view(cg(*operands))
        direct = spec.op(*args, **kw)
        torch.cuda.synchronize()
        check(f"graph {label}: compile_graph fused == {spec.name} op bit "
              f"for bit", torch.equal(out, direct),
              f"max diff {err(out, direct)}")
        check(f"graph {label}: one launch of each fused chain's kernel",
              bool(fused_units) and all(counts.get(f) == 1
                                        and on_device[f] == 1
                                        for f in fused_units),
              f"fused {fused_units}; wrapper launches {counts}; device "
              f"kernels {on_device}; windows that lost device events "
              f"{lost}")
        st, st_ops, st_view = R.compile_spec(spec, args, prefer="staged",
                                             **kw)
        staged = st_view(st(*st_ops))
        unfused = spec.unfused(*args, **kw)
        torch.cuda.synchronize()
        check(f"graph {label}: prefer='staged' == {spec.name} unfused bit "
              f"for bit ({len(st.units)} launches)",
              torch.equal(staged, unfused)
              and all(u.kind == "node" for u in st.units),
              f"max diff {err(staged, unfused)}")
        print("graph_plan " + json.dumps({
            "graph": label, "units": [[u.kind, u.out_node, u.launch]
                                      for u in cg.units],
            "edges": [{"edge": e.edge.label, "mode": e.mode,
                       "hbm_bytes_saved": e.hbm_bytes_saved,
                       "rationale": e.rationale} for e in cg.plan.edges],
            "hbm_bytes_saved": cg.plan.hbm_bytes_saved,
            "estimate_us": {"graph": cg.plan.estimate.total_s * 1e6,
                            "unfused": cg.plan.estimate.unfused_s * 1e6}}),
            flush=True)


def _serve_run(torch, model, params, tokens, place, n_steps):
    """Uncompiled prefill of ``tokens`` and ``n_steps`` greedy decode
    steps: each step's logits and tokens (whole) as numpy arrays (a
    spawned rank returns them through a pipe), the prefill's wall ms (its
    second call: the first resolves the plans) and each decode step's
    (the first one resolves its plans)."""
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.runtime import sharding as shlib
    b, s = tokens.shape
    prefill = steps_lib.make_prefill_step(model, compiled=False)
    decode = steps_lib.make_decode_step(model, compiled=False)
    batch = place({"tokens": tokens}, ("batch", "seq"))
    prefill(params, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    walls = [(time.perf_counter() - t0) * 1e3]
    cache = serve_lib.pad_cache_to(cache, s, s + n_steps, 2)
    cur = shlib.full_tensor(torch.argmax(logits, dim=-1).to(torch.int32))
    out = {"logits": [shlib.full_tensor(logits).float().cpu().numpy()],
           "tokens": []}
    lengths = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    for _ in range(n_steps):
        t0 = time.perf_counter()
        cur, logits, cache = decode(
            params, place({"token": cur, "lengths": lengths}, ("batch",)),
            cache)
        cur = shlib.full_tensor(cur)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        out["logits"].append(shlib.full_tensor(logits).float().cpu().numpy())
        out["tokens"].append(cur.cpu().numpy())
        lengths = lengths + 1
    out["wall_ms"] = walls
    return out


def _adafactor_run(model, params, batch, n_steps):
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import adafactor
    opt = adafactor.init(params)
    step = steps_lib.make_train_step(
        model, optimizer="adafactor",
        opt_cfg=adafactor.AdafactorConfig(warmup_steps=1), compiled=False)
    losses = []
    for _ in range(n_steps):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    return losses


def _l_models():
    from repro_torch.configs.base import get_config, smoke_config
    serve_cfg = get_config(MESH_SERVE["arch"]).replace(
        compute_dtype="float32")
    train_cfg = smoke_config(MESH_TRAIN["arch"]).replace(attn_impl="xla")
    return serve_cfg, train_cfg


def _l_inputs(torch, serve_cfg, train_cfg, dev):
    gen = torch.Generator().manual_seed(29)
    tokens = torch.randint(1, serve_cfg.vocab, (MESH_SERVE["batch"],
                                                MESH_SERVE["prompt"]),
                           generator=gen).to(dev)
    batch = {k: v.to(dev) for k, v in train_batch(
        torch, train_cfg, MESH_TRAIN["batch"], MESH_TRAIN["seq"]).items()}
    return tokens, batch


def l_mesh(rank, world):
    """Phase l's 4-rank spawn on the card: full-width qwen1.5-0.5B served
    by the uncompiled steps on DTensors (params by ``init_params``: each
    leaf drawn whole from seed 0, as ``model.init`` draws it), then smoke
    grok-1 trained by Adafactor, on the (data 2, model 2) host mesh.
    Last, ``launch/serve.py``'s ``serve_bench`` with ``--layer-graph`` at
    MESH_CLI's arguments, cut to its ``lg_layers`` layers, on the group
    as torchrun would join it. Every rank returns its peak memory; rank 0
    the outputs."""
    torch, dev = _j_rank_setup()
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import sharding as shlib
    serve_cfg, train_cfg = _l_models()
    tokens, batch = _l_inputs(torch, serve_cfg, train_cfg, dev)
    mesh = make_host_mesh(device_type="cuda")
    out = {}
    for key, cfg in (("serve", serve_cfg), ("train", train_cfg)):
        model = build_model(cfg)
        with shlib.use_sharding(mesh, overrides=cfg.rule_overrides):
            params = steps_lib.init_params(
                model, torch.Generator(device=dev).manual_seed(0), dev)

            def place(tree, axes):
                return shlib.place_tree(tree, {k: axes for k in tree})
            if key == "serve":
                out[key] = _serve_run(torch, model, params, tokens, place,
                                      MESH_SERVE["steps"])
                out["serve_launches"] = {n: w.launches for n, w in
                                         wrappers().items() if w.launches}
            else:
                out[key] = _adafactor_run(
                    model, params,
                    place(batch, ("batch", "seq")), MESH_TRAIN["steps"])
        del params
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    lg = serve.serve_bench(Namespace(**{
        **SERVE, **MESH_CLI["args"], "layer_graph": True,
        "n_layers": MESH_CLI["lg_layers"],
        "dist_backend": MESH_CLI["backend"]}))
    out["layer_graph"] = {k: lg[k] for k in (
        "mesh", "bitwise_max_abs_diff", "token_count_parity", "ranks_agree",
        "kernel_launches")}
    out["layer_graph"]["wall_s"] = time.perf_counter() - t0
    return out if rank == 0 else {"peak_gib": out["peak_gib"]}


def check_mesh(torch, dev, tmp):
    """Phase l's mesh checks: the 4-rank spawn (:func:`l_mesh`) against
    the same steps on 1 rank in this process, and its layer-graph serve:
    every rank's tokens the same, the paged vs dense difference finite,
    rows 4 and 6 launched on rank 0. Returns rank 0's launches of rows 4
    and 6 by path."""
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import build_model
    outs = spawn_ranks(l_mesh, MESH_SERVE["ranks"],
                       init_file=f"{tmp}/mesh", backend="gloo_staged",
                       timeout=600)
    mesh = outs[0]
    serve_cfg, train_cfg = _l_models()
    tokens, batch = _l_inputs(torch, serve_cfg, train_cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(serve_cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    one = _serve_run(torch, model, params, tokens, lambda t, a: t,
                     MESH_SERVE["steps"])
    one_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, model
    errs = [float(abs(a - b).max()) for a, b in zip(mesh["serve"]["logits"],
                                                    one["logits"])]
    same = all((a == b).all() for a, b in zip(mesh["serve"]["tokens"],
                                              one["tokens"]))
    check(f"mesh serving: full-width {MESH_SERVE['arch']} f32, prefill "
          f"{MESH_SERVE['batch']} x {MESH_SERVE['prompt']} and "
          f"{MESH_SERVE['steps']} decode steps on {MESH_SERVE['ranks']} "
          f"ranks (data 2, model 2) vs 1 rank: logits within "
          f"{MESH_SERVE['tol']}, tokens equal",
          max(errs) <= MESH_SERVE["tol"] and same,
          f"max |logits| err per step {errs}; tokens equal {same}")
    print("mesh_serve " + json.dumps({
        "card": smi_line(), "ranks": MESH_SERVE["ranks"],
        "mesh": "data 2 x model 2", "backend": "gloo_staged",
        "prefill_ms": {"mesh": mesh["serve"]["wall_ms"][0],
                       "one_rank": one["wall_ms"][0]},
        "decode_ms": {"mesh": mesh["serve"]["wall_ms"][1:],
                      "one_rank": one["wall_ms"][1:]},
        "peak_gib_a_rank": [o["peak_gib"] for o in outs],
        "one_rank_peak_gib": one_peak, "max_logit_err": errs,
        "launches_rank0": mesh["serve_launches"]}), flush=True)
    model = build_model(train_cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    one_losses = _adafactor_run(model, params, batch,
                                MESH_TRAIN["steps"])
    diffs = [abs(a - b) for a, b in zip(mesh["train"], one_losses)]
    check(f"Adafactor on the mesh: smoke {MESH_TRAIN['arch']} "
          f"{MESH_TRAIN['steps']} steps on {MESH_SERVE['ranks']} ranks vs "
          f"1 rank, losses within {MESH_TRAIN['tol']}",
          max(diffs) <= MESH_TRAIN["tol"],
          f"mesh {mesh['train']}, one rank {one_losses}")
    print("mesh_adafactor " + json.dumps({
        "mesh_losses": mesh["train"], "one_rank_losses": one_losses,
        "max_diff": max(diffs)}), flush=True)
    lg = mesh["layer_graph"]
    n_layers = MESH_CLI["lg_layers"]
    check(f"serve_bench --layer-graph on the mesh ({n_layers} layers of "
          f"{MESH_SERVE['arch']}): ranks agree, token counts equal, paged vs "
          f"dense difference finite",
          lg["mesh"] == {"data": 2, "model": 2} and lg["ranks_agree"]
          and lg["token_count_parity"]
          and math.isfinite(lg["bitwise_max_abs_diff"]), json.dumps(lg))
    out = {}
    for row in ("ff_layer_matmul", "ff_layer_mlp_tail"):
        n = lg["kernel_launches"].get(MESH_CLI_ROWS[row], 0)
        check(f"serve_bench --layer-graph on the mesh: {row} launched on "
              f"rank 0", n > 0, f"{n} launches")
        out[row] = {f"serve[mesh 2x2 layer-graph {n_layers} layers]": n}
    print("mesh_serve_layer_graph " + json.dumps(
        {"card": smi_line(), "n_layers": n_layers, **lg}), flush=True)
    return out


def run_serve_cli(tmp, label, **over):
    """``python -m torch.distributed.run --nproc-per-node 4 -m
    repro_torch.launch.serve`` at MESH_CLI's arguments (and ``over``) on
    the card: (return code, rank 0's --json result or None, wall s, the
    output's tail). Every process it starts is gone when it returns."""
    out = Path(tmp) / f"serve_{label}.json"
    argv = []
    for k, v in {**MESH_CLI["args"], **over}.items():
        flag = "--" + k.replace("_", "-")
        argv += [flag] if v is True else [flag, str(v)]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(MESH_CLI["ranks"]), "-m",
           "repro_torch.launch.serve", "--dist-backend", MESH_CLI["backend"],
           *argv, "--json", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=_sub_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=str(ROOT),
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=MESH_CLI["timeout"])
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    wall = time.perf_counter() - t0
    # rank 0's own lines (torchrun prefixes them), not DTensor's warnings
    err = [ln for ln in stderr.splitlines()
           if ln.startswith("[rank0]") or "Error" in ln]
    result = (json.loads(out.read_text())
              if proc.returncode == 0 and out.exists() else None)
    return (proc.returncode, result, wall,
            stdout[-1500:] + "\n".join(err[-40:]))


def check_serve_cli(torch, tmp):
    """Phase l's serve under torchrun (:func:`run_serve_cli`): every rank
    exits 0, rank 0's result on the (data 2, model 2) mesh with paged ==
    dense bit for bit, equal token counts, every rank's tokens the same
    and rows 1-3 launched on rank 0; the decode step ms against the same
    arguments on 1 rank in this process (compiled steps) and the share of
    tokens by rid equal to it (not gated: in bf16 the sum over "model"
    rounds otherwise than one rank's product). Returns rank 0's launches
    of rows 1-3 by path."""
    from repro_torch.launch import serve
    ranks = MESH_CLI["ranks"]
    rc, mesh, wall, tail = run_serve_cli(tmp, "mesh")
    check(f"serve under torchrun: {ranks} ranks of the card "
          f"({MESH_CLI['backend']}) serving full-width {SERVE['arch']}, "
          f"every rank exits 0", rc == 0 and mesh is not None,
          f"rc {rc}, wall {wall:.1f} s: {tail}")
    if mesh is None:
        return {}
    launches = {row: mesh["kernel_launches"].get(op, 0)
                for row, op in MESH_CLI_ROWS.items()}
    check("serve under torchrun: rank 0's result on the (data 2, model 2) "
          "mesh, paged == dense bitwise, token counts equal, ranks agree",
          mesh["mesh"] == {"data": 2, "model": 2}
          and mesh["bitwise_identical"] and mesh["token_count_parity"]
          and mesh["ranks_agree"],
          {k: mesh[k] for k in ("mesh", "bitwise_max_abs_diff",
                                "token_count_parity", "ranks_agree")})
    for row in PER_OP:
        check(f"serve under torchrun: {row} launched on rank 0",
              launches[row] > 0, f"{launches[row]} launches")
    torch.cuda.reset_peak_memory_stats()
    one = serve.serve_bench(Namespace(**{**SERVE, **MESH_CLI["args"]}))
    same = total = 0
    for kind in ("lockstep", "paged"):
        for rid, toks in one[kind]["outputs"].items():
            got = mesh[kind]["outputs"].get(str(rid), [])
            same += sum(a == b for a, b in zip(got, toks))
            total += len(toks)

    def step_ms(r):
        return {kind: 1e3 * r[kind]["decode_s"] / r[kind]["decode_steps"]
                for kind in ("lockstep", "paged")}
    print("mesh_serve_cli " + json.dumps({
        "card": smi_line(), "ranks": ranks, "mesh": mesh["mesh"],
        "backend": MESH_CLI["backend"], "args": MESH_CLI["args"],
        "wall_s": wall,
        "decode_step_ms": {"mesh": step_ms(mesh), "one_rank": step_ms(one)},
        "prefill_s": {kind: {"mesh": mesh[kind]["prefill_s"],
                             "one_rank": one[kind]["prefill_s"]}
                      for kind in ("lockstep", "paged")},
        "decode_steps": {kind: {"mesh": mesh[kind]["decode_steps"],
                                "one_rank": one[kind]["decode_steps"]}
                         for kind in ("lockstep", "paged")},
        "tokens_equal_to_one_rank": same / max(total, 1),
        "one_rank_compiled_graphs": one["compiled_graphs"],
        "launches_rank0": launches}), flush=True)
    return {row: {f"serve[mesh {ranks // 2}x2]": n}
            for row, n in launches.items() if row in PER_OP}


def start_l_dryruns():
    """The phase-l dry-run cells, each a subprocess on 256 fake ranks
    writing ``experiments/dryrun_torch/``; the prefill cell's is followed
    by the hillclimb on it (its base). Host work only: it runs beside the
    phases after l. Returns [(cell, process, start time)]."""
    dry = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    hill = " ".join([sys.executable, "experiments/hillclimb_torch.py",
                     *L_HILLCLIMB])
    started = []
    for arch, shape in L_DRY_CELLS:
        cmd = dry + ["--arch", arch, "--shape", shape]
        if (arch, shape) == tuple(L_HILLCLIMB[1].split(":")):
            cmd = ["bash", "-c", " ".join(cmd) + " && " + hill]
        started.append(((arch, shape), subprocess.Popen(
            cmd, env=_sub_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=str(ROOT),
            start_new_session=True), time.perf_counter()))
    return started


def check_l_dryruns(started):
    """Each phase-l cell's result and roofline row (:func:`start_l_dryruns`,
    waited for here), and the hillclimb's table."""
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import OUT_DIR
    t0 = time.perf_counter()
    rows = []
    try:
        for (arch, shape), proc, t1 in started:
            stdout, stderr = proc.communicate(timeout=900)
            wall = time.perf_counter() - t1
            cell = Path(OUT_DIR) / f"{arch}__{shape}__pod16x16.json"
            result = json.loads(cell.read_text()) if cell.exists() else {}
            check(f"dryrun {arch} x {shape} x pod16x16 (256 fake ranks)",
                  bool(result.get("ok")),
                  f"wall {wall:.1f} s: {stdout[-300:]}"
                  f"{result.get('error', '')}{stderr[-1500:]}")
            if result.get("ok"):
                row = roofline.analyze_cell(result)
                rows.append(row)
                print("dryrun " + json.dumps({
                    "cell": result["cell"], "wall_s": wall,
                    "timings": result.get("timings"),
                    "memory": result["memory"], "roofline": row}),
                    flush=True)
            if "hillclimb_torch.py" in " ".join(proc.args):
                check(f"experiments/hillclimb_torch.py "
                      f"{' '.join(L_HILLCLIMB)}",
                      proc.returncode == 0 and "bottleneck:" in stdout,
                      f"rc {proc.returncode}: {stdout[-1200:]}"
                      f"{stderr[-1500:]}")
    finally:
        for _, proc, _ in started:
            if proc.poll() is None:     # the bash of a chain, and its child
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    if rows:
        print(roofline.markdown_table(rows), flush=True)
    print(f"l. dry runs and hillclimb (beside the phases after l): waited "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{time.perf_counter() - started[0][2]:.1f} s since their start",
          flush=True)


def phase_l(torch, dev):
    """Phase l: the StreamGraph layer on the card and serving and
    Adafactor on the 4-rank mesh; the dry-run cells start here and run
    beside the later phases (:func:`check_l_dryruns` collects them).
    Returns what :func:`start_l_dryruns` started and the torchrun serve
    runs' launches on rank 0 (:func:`check_serve_cli`)."""
    import tempfile
    t0 = time.perf_counter()
    walls = {}
    cli_launches = {}
    started = start_l_dryruns()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_l_") as tmp:
        for name, fn in (("serve_cli", lambda: cli_launches.update(
                             check_serve_cli(torch, tmp))),
                         ("mesh", lambda: cli_launches.update(
                             check_mesh(torch, dev, tmp))),
                         ("graphs", lambda: check_graphs(torch, dev))):
            t1 = time.perf_counter()
            try:
                fn()
            except Exception:   # noqa: BLE001 — a failed part fails
                import traceback
                check(f"phase l {name} ran to its end", False,
                      traceback.format_exc()[-3000:])
            walls[name] = time.perf_counter() - t1
    print(f"l. serve under torchrun, graphs, mesh serving, Adafactor: "
          f"{time.perf_counter() - t0:.1f} s {json.dumps(walls)}",
          flush=True)
    return started, cli_launches


def phase_k(torch, dev):
    """Phase k: the chaos suite on the card, the four examples, the
    feed-forward specs against the kernels, the full-width dry-run cell.
    The subprocesses hold their own CUDA contexts; this process holds
    nothing on the card yet."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_k_") as tmp:
        walls = {}
        dry = start_dryrun(tmp)
        try:
            for name, fn in (("chaos", lambda: chaos_check(tmp)),
                             ("examples", lambda: examples_check(tmp)),
                             ("feedforward",
                              lambda: feedforward_check(torch, dev)),
                             ("dryrun", lambda: dryrun_check(tmp, dry))):
                t1 = time.perf_counter()
                fn()
                walls[name] = time.perf_counter() - t1
        finally:
            if dry[0].poll() is None:
                dry[0].kill()
                dry[0].wait()
    print(f"k. chaos, examples, specs, dry run: "
          f"{time.perf_counter() - t0:.1f} s {json.dumps(walls)}",
          flush=True)


def ptxas_stack_frames(log):
    """(entry, properties) for each kernel entry of a ptxas -v log whose
    stack frame is not empty (its spills); the entry's mangled name, at
    most 80 characters of it."""
    out, entry = [], None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            entry = ln.split("Function properties for", 1)[1].strip()
        elif entry and "bytes stack frame" in ln:
            if not ln.strip().startswith("0 bytes stack frame"):
                out.append((entry[:80], ln.strip()))
            entry = None
    return out


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "CUDA card (see the module docstring).")
    ap.add_argument("--decode-timing", action="store_true",
                    help="build, then only time the decode-attention rows "
                    "(phase f's time_decode) and print them as one "
                    "decode_timing line: to compare two trees in one call")
    ap.add_argument("--f32-timing", action="store_true",
                    help="build, then only time the float32 bodies at the "
                    "shapes of their bf16 rows (time_f32_bodies) and print "
                    "one f32_bodies line: to compare two trees in one call")
    ap.add_argument("--dist", action="store_true",
                    help="build, then run only phase j (the distributed "
                    "runtime) and print its lines")
    ap.add_argument("--phase-l", action="store_true",
                    help="build, then run only phase l (graphs, the mesh "
                    "serving steps and Adafactor, the dry-run cells)")
    ap.add_argument("--train-lr-sweep", action="store_true",
                    help="build nothing; train full-width llama3.2-1b for "
                    "phase i's steps at each of TRAIN_LRS and print one "
                    "train_lr line")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    if opts.train_lr_sweep:
        train_lr_sweep(torch, dev)
        return 0
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    built = _build.build()
    for name, (secs, log) in built.items():
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"built {name}.cu in {secs:.1f} s; " + " | ".join(ptxas),
              flush=True)
        for entry, props in ptxas_stack_frames(log):
            print(f"  stack frame in {entry}: {props}", flush=True)
    print(f"a. build: {time.perf_counter() - t0:.1f} s", flush=True)

    if opts.f32_timing:
        time_f32_bodies(torch, dev, main_path_shapes(torch))
        print(smi_line(), flush=True)
        return 0
    if opts.phase_l:
        check_l_dryruns(phase_l(torch, dev)[0])
        return 1 if failures else 0
    # phase j first: its ranks share the card with this process, which
    # holds nothing on it yet
    dist_launches = dist_phase(torch, dev)
    if opts.dist:
        return 1 if failures else 0
    # phase k while this process still holds nothing on the card: the
    # chaos suite starts 8 ranks on it
    phase_k(torch, dev)
    # phase l: its ranks too want the card before this process fills it;
    # its dry runs go on beside the phases below
    l_dryruns, cli_launches = phase_l(torch, dev)
    shapes = main_path_shapes(torch)
    if opts.decode_timing:
        rows = time_decode(torch, dev, shapes)
        print("decode_timing " + json.dumps(
            {k: split_bound(r) for k, r in rows.items()}), flush=True)
        return 0
    main_err = check_kernels(torch, dev, shapes)
    main_err.update(check_layer_kernels(torch, dev, shapes))
    main_err.update(check_library_kernels(torch, dev, shapes))
    adamw_err, adamw_row = check_adamw_kernel(torch, dev)
    main_err.update(adamw_err)
    check_decode_layer(torch, dev, shapes)
    check_model_small(torch, dev)
    check_model_small(torch, dev, impl="xla")
    main_err.update(check_scan_kernel(torch, dev))
    check_attention_head_dims(torch, dev)
    check_ssm_small(torch, dev)
    check_moe_small(torch, dev)
    for arch, name in HEADS:
        check_heads(torch, dev, arch, name)
    check_layer_kernels(torch, dev, main_path_shapes(torch, "llama3_2_1b"),
                        name="llama3.2-1b")
    check_layer_kernels(torch, dev, main_path_shapes(torch, "qwen2_72b"),
                        name="qwen2-72b")
    check_new_models_small(torch, dev)

    launches = run_serve(torch, "default", PER_OP)
    run_serve(torch, "prompt-256", PER_OP, prompt_len=256)
    launches.update({k: v for k, v in run_serve(
        torch, "layer-graph", LAYER_GRAPH, layer_graph=True).items()
        if k.startswith("ff_layer")})
    grok_launches = run_serve(torch, GROK["arch"], PER_OP, **GROK)
    new_launches = run_new_serves(torch, dev)
    launches.update(run_library_path(torch, dev, shapes))
    scan_launches = run_ssm_models(torch, dev)
    launches["ff_chunk_scan"] = sum(scan_launches.values())
    run_steps_model(torch, dev, DEEPSEEK, (),
                    "attn_impl 'xla', as the reference")
    internvl_launches = run_steps_model(torch, dev, INTERNVL, PER_OP[:2])
    run_steps_model(torch, dev, WHISPER, (),
                    "every attention of encdec is the reference's unfused "
                    "path, whatever attn_impl says")
    launches["adamw"] = train_phase(torch, dev)["adamw"]

    rows = time_kernels(torch, dev, shapes)
    rows["adamw"] = adamw_row
    rows.update(time_layer_kernels(torch, dev, shapes))
    for name, row in time_layer_kernels(
            torch, dev, main_path_shapes(torch, "qwen2_72b")).items():
        row["launches_on_path"] = new_launches[
            "qwen2_72b-layer-graph"][name]
        rows[name]["more"] = [split_bound(row)]
    rows.update(time_library_kernels(torch, dev, shapes))
    for name, more in time_f32_bodies(torch, dev, shapes,
                                      scan=False).items():
        rows[name].setdefault("more", []).extend(more)
    sweep = depth_sweep(torch, dev, shapes)
    rows.update(time_scan_kernel(torch, dev, scan_launches))
    check_compiled_steps(torch, dev)
    runs = profile_decode(torch, dev)
    plan_phase(torch, dev, sweep, runs, shapes)
    check_l_dryruns(l_dryruns)
    kernels = []
    for name, meta in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", **meta,
                        "launches": launches[name],
                        "max_abs_err": main_err[name],
                        **split_bound(rows[name])})
        if name == "ff_layer_swiglu":
            kernels[-1]["note"] = ("on the main path its work runs inside "
                                   "ff_layer_mlp_tail; launched standalone "
                                   "by phase b")
        if name == "ff_chunk_scan":
            kernels[-1]["launches_by_path"] = scan_launches
        if name == "adamw":
            kernels[-1]["note"] = ("hand-fused, no Pallas counterpart: the "
                                   "update XLA fuses into the reference's "
                                   "jitted train step; launches on the "
                                   "train path (phase i's trainer runs)")
        if name in PER_OP:
            kernels[-1]["launches_by_path"] = {
                "serve[default]": launches[name],
                f"serve[{GROK['arch']}]": grok_launches[name],
                **{f"serve[{label}]": n[name]
                   for label, n in new_launches.items()},
                f"model[{INTERNVL['arch']}]": internvl_launches.get(name, 0)}
        if name in ("ff_layer_matmul", "ff_layer_mlp_tail"):
            kernels[-1]["launches_by_path"] = {
                "serve[layer-graph]": launches[name],
                **{f"serve[{label}]": n[name]
                   for label, n in new_launches.items()
                   if label.endswith("layer-graph")}}
        if name in dist_launches:
            kernels[-1].setdefault("launches_by_path", {
                "main path": launches[name]}).update(dist_launches[name])
        if name in cli_launches:
            kernels[-1].setdefault("launches_by_path", {
                "main path": launches[name]}).update(cli_launches[name])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
