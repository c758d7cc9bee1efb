"""Roofline analysis over the dry-run artifacts (the port of
``repro/launch/roofline.py``).

Per (arch x shape x mesh) cell, from experiments/dryrun_torch/<cell>.json:

  compute term    = FLOPs / peak_FLOPs                (per device)
  memory term     = bytes / HBM_bw                    (per device)
  collective term = ring-model wire seconds           (per device)

where FLOPs, bytes and collectives are extrapolated exactly from the L=1
and L=2 variants: total = f(1) + (units-1) * (f(2) - f(1)). The dry run
counts them per operation on each rank's local shards
(:mod:`repro_torch.launch.dryrun`: its bytes are every operation's
operands and results, not a fused program's traffic).

MODEL_FLOPS is the analytic useful-work floor:
  train:    6 * N_eff * tokens  (+ attention/scan term)
  prefill:  2 * N_eff * tokens  (+ attention/scan term)
  decode:   2 * N_eff * batch   (+ attention-over-cache term)
N_eff = active params minus the embedding lookup table (tied embeddings
count once, as the unembed matmul). The ratio MODEL_FLOPS/FLOPs exposes
remat recompute and dispatch/dead work; the roofline fraction
  RF = (MODEL_FLOPS / chips / peak) / max(terms)
is the headline "how close to roofline" number per cell.

Hardware constants: one NVIDIA H100 SXM (``core/pipeline_model.py``
``H100_SXM``, NVIDIA's datasheet): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3;
LINK_BW below.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core.pipeline_model import H100_SXM

PEAK_FLOPS = H100_SXM.flops
HBM_BW = H100_SXM.hbm_bw
# The ring's slowest hop: a group of 16 ranks spans two 8-card hosts, so a
# ring over it crosses hosts through one card's 400 Gb/s (50 GB/s) NDR
# InfiniBand port (NVIDIA DGX H100 datasheet: eight ConnectX-7 at 400
# Gb/s); NVLink inside a host gives 450 GB/s a direction and is not what
# paces such a ring.
LINK_BW = 50e9
CHIPS = {"pod16x16": 256, "pod2x16x16": 512}


def _extrapolate(result: Dict, field) -> Optional[float]:
    v = result.get("variants")
    if not v:
        return None
    f1, f2 = field(v["L1"]), field(v["L2"])
    units = result["n_layer_units"]
    return f1 + (units - 1) * (f2 - f1)


def model_flops(arch: str, shape_name: str, n_active: int) -> float:
    """Analytic useful FLOPs (global, fwd[+bwd]) for one step."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    d, L = cfg.d_model, cfg.n_layers
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    if cfg.family == "vlm" and shape.kind != "decode":
        tokens += shape.global_batch * cfg.n_patches
    n_eff = n_active
    if not cfg.tie_embeddings:
        n_eff -= cfg.padded_vocab * d          # lookup table: no matmul
    mult = 3.0 if shape.kind == "train" else 1.0
    base = 2.0 * n_eff * tokens * mult
    if cfg.family == "encdec" and shape.kind != "decode":
        # encoder processes B x n_frames tokens through the enc share
        enc_frac = cfg.n_enc_layers / max(cfg.n_enc_layers + cfg.n_layers, 1)
        base += 2.0 * n_eff * enc_frac * shape.global_batch * cfg.n_frames \
            * mult

    # attention / scan mixing term
    h, hd = cfg.n_heads, cfg.hd
    if cfg.family == "ssm":
        n, p = cfg.ssm_head_dim, cfg.ssm_head_dim
        nh = cfg.d_model // cfg.ssm_head_dim
        mix = 8.0 * nh * n * p * L * tokens
    elif cfg.family == "hybrid":
        d_in = cfg.ssm_expand * d
        nh = d_in // cfg.ssm_head_dim
        mix = 8.0 * nh * cfg.ssm_state * cfg.ssm_head_dim * L * tokens
        n_attn = L // cfg.attn_every_n
        ctx = (shape.seq_len / 2 if shape.kind != "decode" else shape.seq_len)
        mix += 4.0 * h * hd * ctx * n_attn * tokens
    else:
        ctx = (shape.seq_len / 2 if shape.kind != "decode" else shape.seq_len)
        n_attn = L + (cfg.n_enc_layers if cfg.family == "encdec" else 0)
        mix = 4.0 * h * hd * ctx * n_attn * tokens
    return base + mix * mult


def analyze_cell(result: Dict) -> Optional[Dict]:
    if result.get("skipped") or not result.get("ok"):
        return None
    chips = CHIPS[result["mesh"]]
    flops = _extrapolate(result, lambda v: v["flops"])
    nbytes = _extrapolate(result, lambda v: v["bytes"])
    coll_s = _extrapolate(result, lambda v: v["collectives"]["total_seconds"])
    coll_b = _extrapolate(result, lambda v: v["collectives"]["total_bytes"])
    if flops is None:
        return None
    t_comp = flops / PEAK_FLOPS
    t_mem = nbytes / HBM_BW
    t_coll = coll_s
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(result["arch"], result["shape"],
                     result["n_active_params"])
    t_ideal = mf / chips / PEAK_FLOPS
    # decode is inherently memory-bound: its roofline floor is the minimum
    # HBM traffic (bf16 active weights + the KV/state cache, once each),
    # so report RF against the memory ideal for decode cells
    shape = SHAPES[result["shape"]]
    rf = t_ideal / max(max(terms.values()), 1e-12)
    if shape.kind == "decode":
        min_bytes = 2.0 * result["n_active_params"] / chips \
            + result["memory"]["argument_bytes"]
        t_ideal_mem = min_bytes / HBM_BW
        rf = t_ideal_mem / max(max(terms.values()), 1e-12)
    return {
        "cell": result["cell"],
        "arch": result["arch"],
        "shape": result["shape"],
        "mesh": result["mesh"],
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "bottleneck": bottleneck,
        # the reference's key names (its later drivers read them); here
        # the counts are the dispatched operations', not HLO's
        "hlo_flops_per_dev": flops,
        "hlo_bytes_per_dev": nbytes,
        "coll_bytes_per_dev": coll_b,
        "model_flops_global": mf,
        "useful_ratio": mf / chips / max(flops, 1.0),
        "roofline_fraction": rf,
        "peak_hbm_gib": result["memory"]["peak_bytes_est"] / 2**30,
    }


def load_all(dry_dir: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dry_dir, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def markdown_table(rows: List[Dict]) -> str:
    hdr = ("| cell | comp (ms) | mem (ms) | coll (ms) | bottleneck "
           "| useful/HLO | RF | HBM GiB |\n"
           "|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} x {r['shape']} ({r['mesh']}) "
            f"| {r['t_compute_s']*1e3:.1f} | {r['t_memory_s']*1e3:.1f} "
            f"| {r['t_collective_s']*1e3:.1f} | {r['bottleneck']} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} "
            f"| {r['peak_hbm_gib']:.1f} |")
    return hdr + "\n".join(lines)


def main():
    import argparse

    from repro_torch.launch.dryrun import OUT_DIR
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry-dir", default=OUT_DIR)
    args = ap.parse_args()
    rows = []
    for result in load_all(args.dry_dir):
        a = analyze_cell(result)
        if a:
            rows.append(a)
        elif result.get("skipped"):
            print(f"SKIP {result['cell']}: {result['reason']}")
        elif not result.get("ok"):
            print(f"FAIL {result['cell']}: {result.get('error')}")
    print(markdown_table(rows))


if __name__ == "__main__":
    main()
