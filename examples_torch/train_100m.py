#!/usr/bin/env python3
"""End-to-end run on the port: train a ~100M-parameter OLMo-family
model on the synthetic pipeline for a few hundred steps through
``repro_torch.launch.train``, checkpoint under
``experiments/train_100m_torch/``.

    python3 examples_torch/train_100m.py --steps 300           # the card
    python3 examples_torch/train_100m.py --device cpu --steps 20
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import train as train_launcher

    # ~105M params: 4 layers, d=768, OLMo vocab (50304) dominates.
    return train_launcher.main([
        "--arch", "olmo-1b", "--smoke",
        "--d-model", "768", "--n-layers", "4",
        "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--lr", "3e-4",
        "--ckpt", "experiments/train_100m_torch/ckpt.npz",
        "--log-every", "10",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
