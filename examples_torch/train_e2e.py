"""End-to-end training on the PyTorch/CUDA port (twin of
``examples/train_e2e.py``): train a small LM (stablelm family, the reduced
``--smoke`` width) for a few hundred steps on the Markov corpus and watch
the loss drop.  On the card the same launcher trains the full configs
(``python -m repro_torch.launch.train --arch stablelm-1.6b``).

    PYTHONPATH=src python examples_torch/train_e2e.py [--steps 300] [--device cpu]

Checkpoints go to ``--ckpt-dir`` (default: ``repro_torch_ckpt`` in the
system's temporary directory); a directory that already holds one resumes
from it, as the launcher does.
"""
import argparse
import os
import tempfile

from repro_torch.checkpoint import latest_step
from repro_torch.launch import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    losses = train.main([
        "--arch", "stablelm-1.6b", "--smoke",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "64", "--lr", "3e-3",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--log-every", "20", "--device", args.device,
    ])
    assert losses[-1] < losses[0], "loss did not decrease"
    print("OK — loss decreased; checkpoints in", args.ckpt_dir)
    return {"steps": len(losses), "first_loss": losses[0],
            "last_loss": losses[-1],
            "latest_checkpoint": latest_step(args.ckpt_dir)}


if __name__ == "__main__":
    main()
