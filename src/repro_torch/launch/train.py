"""Training launcher: the paper's data-parallel trainer, on the card unless
``--device cpu``:

    python -m repro_torch.launch.train --arch smollm-360m --faithful \\
        --seq-len 1024 --global-batch 8 --steps 6
    python -m repro_torch.launch.train --arch smollm-360m --smoke \\
        --device cpu --faithful --steps 3
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-360m --mesh local --faithful --seq-len 1024 --global-batch 16

``--mesh local`` joins the group ``torchrun`` describes (NCCL on cuda,
gloo on cpu) and is one worker without it; ``--mesh single`` is always one
worker.  ``--shape`` takes the reference's shape names, and ``--seq-len`` /
``--global-batch`` override them for a reduced shape.  Restart the same
command after a failure: the loop resumes from the newest checkpoint in
``--ckpt-dir`` and replays the deterministic data stream.  The weights are
random, from ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import local_group, make_production_mesh, single_device_group
from repro_torch.optim import OptConfig
from repro_torch.train import LoopConfig, TrainSettings, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=list(SHAPES), default="train_4k")
    ap.add_argument("--seq-len", type=int, default=None, help="override the shape's")
    ap.add_argument("--global-batch", type=int, default=None, help="override the shape's")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + small shape (CPU dev)")
    ap.add_argument("--mesh", choices=("local", "single", "production", "multipod"),
                    default="local")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", choices=("adam", "adamw", "momentum",
                                            "rmsprop", "sgd"), default="adam")
    ap.add_argument("--slices", type=int, default=1,
                    help="paper §5.1 input slicing (gradient accumulation)")
    ap.add_argument("--faithful", action="store_true",
                    help="paper-faithful replicated-parameter DP")
    ap.add_argument("--flat-engine", choices=("auto", "zero", "off"), default="auto")
    ap.add_argument("--attn-impl", choices=("chunked", "kernel"), default="kernel")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.mesh in ("production", "multipod"):
        make_production_mesh(multi_pod=args.mesh == "multipod")   # raises
    if args.smoke:
        cfg = get_smoke_config(args.arch)
        shape = ShapeConfig("smoke", "train", 64, 8)
    else:
        cfg = get_config(args.arch)
        shape = SHAPES[args.shape]
    if args.seq_len or args.global_batch:
        shape = dataclasses.replace(shape, name=f"{shape.name}-reduced",
                                    seq_len=args.seq_len or shape.seq_len,
                                    global_batch=args.global_batch or shape.global_batch)
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    group = (single_device_group(args.device) if args.mesh == "single"
             else local_group(args.device))
    try:
        t0 = time.perf_counter()
        res = train(
            cfg, shape, group,
            OptConfig(kind=args.optimizer, lr=args.lr),
            TrainSettings(num_slices=args.slices, faithful=args.faithful,
                          flat_engine=args.flat_engine),
            LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, seed=args.seed),
        )
        wall = time.perf_counter() - t0
    finally:
        group.close()
    if group.rank == 0:
        print(f"final loss: {res['final_loss']:.4f}  skipped steps: "
              f"{res['skipped_steps']}  ({args.steps} steps of {shape.global_batch} x "
              f"{shape.seq_len} on {group.world} x {group.device.type}, {wall:.1f} s)")
    return res


if __name__ == "__main__":
    main()
