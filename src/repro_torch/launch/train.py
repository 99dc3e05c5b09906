"""Training launcher of the port (``src/repro/launch/train.py``).  On the
card::

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --steps 20 --batch 8 --seq 512

and on the CPU ``--device cpu`` (the reduced variants with ``--smoke``).
The flags and printout are the reference's, plus ``--device``.  The step
runs under a mesh, as the reference's does: a one-slot (1, 1) host mesh on
the training device, so the MoE and, for a config with
``ssm_seq_parallel``, the SSD take their mesh paths with one shard; with
``--production-mesh`` the 16 x 16 pod mesh, which raises with the count
when fewer CUDA devices are visible.  Weights are random from seed 0 on
the training device; encoder frames and vision patches of step i come
from a generator seeded with i there.

A resumed run restores ``{"params", "opt"}`` from the latest checkpoint
and starts a fresh data iterator, so it trains on batch 0, 1, ... again,
as the reference's launcher does (ROADMAP Queue 3 notes it).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, List, NamedTuple

import torch

from ..checkpoint import latest_step, load_checkpoint, save_checkpoint
from ..configs import ARCH_IDS, get_config
from ..data import make_train_iterator
from ..device import make_generator, resolve_device
from ..models.model import build_model
from ..optim import adamw_init
from . import steps as ST
from .mesh import make_host_mesh, make_production_mesh, mesh_axis_sizes


class TrainRun(NamedTuple):
    """What :func:`run` leaves: per step its loss, grad norm and host
    seconds (each step ends in a host read of its loss), and the final
    parameters and optimizer state."""
    losses: List[float]
    grad_norms: List[float]
    step_s: List[float]
    start: int
    params: Any
    opt: Any


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced variant of the same family (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 pod mesh (requires 256 devices)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def run(argv=None) -> TrainRun:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    mesh = make_production_mesh() if args.production_mesh else \
        make_host_mesh(devices=[dev])
    stacked = model.supports_stacked
    step_fn = ST.make_train_step(model, mesh, lr=args.lr,
                                 total_steps=args.steps, stacked=stacked)
    init = model.init_stacked if stacked else model.init
    params = init(make_generator(0, dev), dev)
    opt = adamw_init(params)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start, restored = load_checkpoint(args.ckpt_dir,
                                          like={"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        print(f"[train] resumed from step {start}")

    n_params = model.param_count(params)
    print(f"[train] {cfg.name} ({'smoke' if args.smoke else 'full'}) "
          f"params={n_params / 1e6:.1f}M mesh={mesh_axis_sizes(mesh)} "
          f"device={dev}")

    it = make_train_iterator(vocab=cfg.vocab, global_batch=args.batch,
                             seq=args.seq)
    losses, gnorms, step_s = [], [], []
    t0 = time.time()
    for i in range(start, args.steps):
        t_step = time.perf_counter()
        raw = next(it)
        batch = {"tokens": torch.as_tensor(raw["tokens"], device=dev)}
        if cfg.enc_dec:
            batch["frames"] = torch.randn(
                (args.batch, cfg.enc_seq, cfg.d_model),
                generator=make_generator(i, dev), device=dev)
        if cfg.frontend == "vision":
            batch["patches"] = torch.randn(
                (args.batch, cfg.n_patches, cfg.d_model),
                generator=make_generator(i, dev), device=dev)
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        step_s.append(time.perf_counter() - t_step)
        if (i + 1) % args.log_every == 0:
            dt = (time.time() - t0) / args.log_every
            tok_s = args.batch * args.seq / dt
            print(f"[train] step {i + 1:5d} loss={losses[-1]:.4f} "
                  f"ce={float(metrics['ce']):.4f} gnorm={gnorms[-1]:.3f} "
                  f"{dt * 1e3:.0f} ms/step {tok_s:.0f} tok/s", flush=True)
            t0 = time.time()
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1,
                            {"params": params, "opt": opt})
    if losses:
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"over {len(losses)} steps")
    return TrainRun(losses, gnorms, step_s, start, params, opt)


def main(argv=None) -> List[float]:
    """The launcher: -> the loss of every step it ran."""
    return run(argv).losses


if __name__ == "__main__":
    main()
