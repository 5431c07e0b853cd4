"""Train a reduced-config LM for a few hundred steps with checkpointing, on
the PyTorch port: the counterpart of `examples/train_tiny_lm.py`.

Any of the 10 configs works:

    PYTHONPATH=src python examples/train_tiny_lm_torch.py --arch mamba2-130m --device cpu
    PYTHONPATH=src python examples/train_tiny_lm_torch.py --arch deepseek-moe-16b   # on a card
"""

import argparse
import os
import tempfile

from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    state, hist = train(args.arch, steps=args.steps, batch=8, seq=128, lr=3e-3,
                        ckpt_dir=args.ckpt_dir, save_every=50, log_every=20, device=args.device)
    print(f"final loss: {hist[-1]['loss']:.4f} "
          f"(from {hist[0]['loss']:.4f} at step {hist[0]['step']})")


if __name__ == "__main__":
    main()
