"""Training launcher: the paper's data-parallel trainer and the
reference's data x model mesh, on the card unless ``--device cpu``:

    python -m repro_torch.launch.train --arch smollm-360m --faithful \\
        --seq-len 1024 --global-batch 8 --steps 6
    python -m repro_torch.launch.train --arch zamba2-1.2b --faithful \\
        --seq-len 1024 --global-batch 4 --slices 2 --steps 4
    python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b --smoke \\
        --device cpu --steps 3
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-360m --mesh local --faithful --seq-len 1024 --global-batch 16
    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch qwen3-moe-30b-a3b --smoke --device cpu --steps 3

Every id of ``ARCH_IDS`` trains, each family through its module's
``loss_fn``.  ``--mesh`` is the reference's: ``local`` lays ``(world,
1)`` (data, model) over the ranks ``torchrun`` describes (NCCL on cuda,
gloo on cpu; one worker without it), ``single`` is one worker,
``production`` and ``multipod`` the reference's ``(16, 16)`` and ``(2,
16, 16)`` pods at a world of 256 or 512 (any other world raises).  The
rules come from ``--faithful``, as the reference's launcher builds them:
the train step derives ``ShardRules.for_mesh(mesh, faithful=--faithful)``
(``tp="model"``, ``sp`` on unless faithful).  Without ``--faithful`` the
default program is the per-parameter path under FSDP (each rank holds 1/N
of every weight and of its Adam moments, and gathers a layer's weights
while it runs) with the ``lm`` family's tensor, sequence and expert
parallelism over ``model``, or zamba2's tensor parallelism (the residual
stream whole over ``model``, as the reference's launcher turns ``sp`` off
for the hybrid family), at a model size of 1 on ``local``: collectives
over one-rank groups; ``--faithful`` selects the paper's flat program
and ``--flat-engine zero`` the ZeRO flat program, both refused where the
model axis is live.  The ``moe`` family always takes the per-parameter
path (as the reference's), under FSDP or, with ``--faithful``,
replicated, and adds its load-balance term to the loss.  The ssm, audio
and vlm families run at a model size of 1 only.  The launcher prints the mesh and
which program runs.  The audio and vlm families' batches carry their
frontend stubs (``frames``, ``patch_embeds``), split with the tokens.

``--shape`` takes the reference's shape names, and ``--seq-len`` /
``--global-batch`` override them for a reduced shape.  Restart the same
command after a failure: the loop resumes from the newest checkpoint in
``--ckpt-dir`` and replays the deterministic data stream (onto any mesh:
the checkpoint holds full leaves).  The weights are random, from
``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import local_mesh, make_production_mesh, single_mesh
from repro_torch.optim import OptConfig
from repro_torch.train import LoopConfig, TrainSettings, train
from repro_torch.train.step import flat_engine_mode, resolve_program, shard_layout_for


def program_name(cfg, group, opt, settings) -> str:
    """Which train program ``train`` runs for these arguments."""
    mode = flat_engine_mode(cfg, group, opt, settings)
    if mode == "faithful":
        return "the faithful flat program (replicated parameters, bucketed all-reduce)"
    if mode == "zero":
        return "the ZeRO flat program (scattered optimizer state)"
    shards = shard_layout_for(cfg, group, settings)
    if shards.sharded:
        text = (f"the per-parameter path under FSDP ({len(shards.sharded)} of "
                f"{len(shards.paths)} leaves sharded over {shards.world} rank(s))")
    else:
        text = "the per-parameter path, replicated"
    _, rules = resolve_program(cfg, group, settings)
    if rules.tp is not None and shards.model > 1:
        kinds = ["tensor"] + ["sequence"] * rules.sp + ["expert"] * bool(cfg.moe.num_experts)
        kinds = ", ".join(kinds[:-1]) + " and " + kinds[-1] if len(kinds) > 1 else kinds[0]
        text += (f", {kinds} parallel over {shards.model} model rank(s) "
                 f"({len(shards.model_sharded)} leaves split)")
    return text


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
    if args.mesh in ("production", "multipod"):
        group = make_production_mesh(multi_pod=args.mesh == "multipod", device=args.device)
    elif args.mesh == "single":
        group = single_mesh(args.device)
    else:
        group = local_mesh(device=args.device)
    opt = OptConfig(kind=args.optimizer, lr=args.lr)
    settings = TrainSettings(num_slices=args.slices, faithful=args.faithful,
                             flat_engine=args.flat_engine)
    try:
        program = program_name(cfg, group, opt, settings)
        if group.rank == 0:
            print(f"[train] mesh {group.describe()} of {group.world} rank(s) on "
                  f"{group.device.type}", flush=True)
            print(f"[train] {cfg.name}: {program}", flush=True)
        t0 = time.perf_counter()
        res = train(
            cfg, shape, group, opt, settings,
            LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, seed=args.seed),
        )
        wall = time.perf_counter() - t0
    finally:
        group.close()
    if group.rank == 0:
        print(f"final loss: {res['final_loss']:.4f}  skipped steps: "
              f"{res['skipped_steps']}  ({args.steps} steps of {shape.global_batch} x "
              f"{shape.seq_len} on the mesh {group.describe()} of {group.device.type}, "
              f"{wall:.1f} s)")
    res["program"] = program
    res["mesh"] = group.shape
    return res


if __name__ == "__main__":
    main()
