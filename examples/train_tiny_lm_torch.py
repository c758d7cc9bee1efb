"""End-to-end training example of the PyTorch/H100 port: a ~100M-parameter
llama-style model trained for a few hundred steps on the synthetic Markov
stream, through the full driver stack (host data pipe -> train step ->
AdamW -> checkpoints -> auto-resume).

Full run (~100M params, on the CUDA card):
  PYTHONPATH=src python examples/train_tiny_lm_torch.py

Reduced run (~10M params; ``--device cpu`` runs on the CPU):
  PYTHONPATH=src python examples/train_tiny_lm_torch.py --tiny --device cpu
"""

import argparse
import os
import sys
import tempfile

from repro_torch.launch import train as train_mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_tiny_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # ~100M params: 12 x 768 llama-style + 32k vocab (or ~10M with --tiny)
    import repro_torch.configs.llama3_2_1b as base_mod
    if args.tiny:
        cfg = base_mod.CONFIG.replace(
            n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, d_ff=1024,
            vocab=1024, compute_dtype="float32")
    else:
        cfg = base_mod.CONFIG.replace(
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
            vocab=32768, compute_dtype="float32")
    # install as a transient "arch" by replacing the smoke config
    base_mod.SMOKE = cfg

    from repro_torch.models import build_model
    n = build_model(cfg).param_count()
    print(f"training {n / 1e6:.1f}M-param model for {args.steps} steps")
    train_mod.main([
        "--arch", "llama3_2_1b", "--smoke",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "256" if not args.tiny else "128",
        "--lr", "3e-3", "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "100", "--log-every", "10",
        "--device", args.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
