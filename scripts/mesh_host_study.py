"""The host cost of the trainer's model axis at a model size of 1.

``chip_smoke.py`` phase 14's model, traffic and settings (qwen3-moe-30b-a3b
at full width, 2 of its 48 layers, seq 512, global batch 4 in 2 slices,
Adam) on one card, stepped by two programs over one 1-rank NCCL group: the
per-parameter step under FSDP (``ShardRules.for_group``) and, where the
tree has the model axis, the mesh step (``ShardRules.for_mesh`` on a
``(1, 1)`` mesh laid over the same group: every model-axis collective over
a 1-rank subgroup).  The runs alternate in one process, FSDP, mesh, FSDP,
mesh, ..., each from the seed-0 init and freed before the next, so neither
program gains from its place in the process; each tree runs in a process
of its own, in the order given:

    python3 scripts/mesh_host_study.py change=build/final \\
        parent=build/parent change=build/final parent=build/parent

Per run: each step's host time to return from the call (``issue_ms``: what
the host spends dispatching it) and to the sync after it (``wall_ms``),
and their medians over the warm steps (all but the first); the Python
calls of one more step (``cProfile``: the host's work a step, free of the
host's speed); the collectives a step (``models.common.COUNTS``).  Per
process: the host time of one call of the model axis' all-gather and
reduce-scatter on the ``(1, 1)`` mesh (a 4 MiB bf16 tensor, the ``(1, 512, 2048)`` residual
stream) and of the copy that moves the same bytes.  The card's name and
power limit, one JSON line per tree, and ``summary.json`` under
``chiprun_out/mesh_host_study/``.  Needs one card.
"""
from __future__ import annotations

import cProfile
import dataclasses
import json
import os
import pathlib
import pstats
import socket
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
OUT = HERE / "chiprun_out" / "mesh_host_study"
LAYERS, SEQ, BATCH, SLICES = 2, 512, 4, 2
STEPS, PAIRS, CALLS = 6, 3, 200


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(torch, dev) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_program(torch, dev, cfg, shape, settings, opt, group, steps: int) -> dict:
    """``steps`` steps of the per-parameter program on ``group`` (a
    ``DataGroup``: FSDP; a ``MeshGroup``: the mesh step) from the seed-0
    init on batches 0, 1, ...; everything is freed before it returns."""
    from repro_torch.data import make_batch_fn
    from repro_torch.models import common
    from repro_torch.train import build_train_step, init_sharded

    batch_fn = make_batch_fn(cfg, shape, 0)
    params, state = init_sharded(cfg, group, opt, 0, settings)
    step_fn = build_train_step(cfg, group, opt, settings)
    common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
    issue, wall, losses = [], [], []
    for i in range(steps):
        batch = batch_fn(i)
        _sync(torch, dev)
        t = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        issue.append((time.perf_counter() - t) * 1e3)
        _sync(torch, dev)
        wall.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"])
    collectives = {k: v // steps for k, v in common.COUNTS.items() if v}
    # the Python calls of one more step: the host work a step, without timing noise
    prof = cProfile.Profile()
    prof.enable()
    params, state, m = step_fn(params, state, batch_fn(steps))
    prof.disable()
    _sync(torch, dev)
    out = dict(python_calls=pstats.Stats(prof).total_calls, issue_ms=issue, wall_ms=wall,
               issue_ms_median=statistics.median(issue[1:]),
               wall_ms_median=statistics.median(wall[1:]),
               losses=[float(x) for x in losses],
               collectives=collectives)
    del params, state, m, step_fn, losses
    _free(torch, dev)
    return out


def collective_cost(torch, dev, mesh, calls: int) -> dict:
    """Host ms a call of the model axis' all-gather and reduce-scatter over
    ``mesh.model`` and of a copy of the same bytes, ``calls`` calls each
    issued back to back and synced once."""
    from repro_torch.models import common

    x = torch.randn(1, SEQ, 2048, device=dev, dtype=torch.bfloat16)
    fns = {"model_all_gather": lambda: common.model_all_gather(x, 1, mesh.model),
           "model_reduce_scatter": lambda: common.model_reduce_scatter(x, 1, mesh.model),
           "copy": lambda: x.clone()}
    out = {}
    for name, fn in fns.items():
        fn()
        _sync(torch, dev)
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        _sync(torch, dev)
        out[name] = (time.perf_counter() - t) * 1e3 / calls
    return out


def study(torch, dev, cfg, shape, settings, opt, group, steps=STEPS, pairs=PAIRS) -> dict:
    """FSDP and, where the tree has it, the mesh step, alternating."""
    from repro_torch.launch import mesh as mesh_mod

    mesh = (mesh_mod.mesh_from_group(group, (1, 1))
            if hasattr(mesh_mod, "MeshGroup") else None)
    runs = []
    for _ in range(pairs):
        runs.append(dict(program="fsdp", **run_program(torch, dev, cfg, shape, settings,
                                                       opt, group, steps)))
        if mesh is not None:
            runs.append(dict(program="mesh", **run_program(torch, dev, cfg, shape, settings,
                                                           opt, mesh, steps)))
    out = {"runs": runs}
    for prog in ("fsdp", "mesh"):
        mine = [r for r in runs if r["program"] == prog]
        if mine:
            out[prog] = {k: statistics.median(x for r in mine for x in r[k][1:])
                         for k in ("issue_ms", "wall_ms")}
            out[prog]["python_calls"] = statistics.median(r["python_calls"] for r in mine)
    if mesh is not None:
        out["collective_ms"] = collective_cost(torch, dev, mesh, CALLS)
    return out


def one(tree: pathlib.Path) -> dict:
    """Build the tree's kernels and run :func:`study` in this process."""
    os.chdir(tree)
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import init_group
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainSettings

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    _build.build_all()
    for name in _build.sources():
        _build.load(name)
    build_s = time.perf_counter() - t
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_layers=LAYERS,
                              attn_impl="kernel")
    shape = ShapeConfig("mesh-host-study", "train", SEQ, BATCH)
    group = init_group("nccl", 0, 1, f"tcp://127.0.0.1:{_free_port()}", device=dev)
    try:
        return dict(build_s=build_s, **study(torch, dev, cfg, shape,
                                             TrainSettings(num_slices=SLICES),
                                             OptConfig(kind="adam"), group))
    finally:
        group.close()


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print("STUDY " + json.dumps(one(pathlib.Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    runs, failed = [], False
    for i, arg in enumerate(argv):
        label, _, path = arg.rpartition("=")
        label = label or path
        log = OUT / f"{i}-{label.replace('/', '_')}.log"
        with open(log, "w") as f:
            p = subprocess.run([sys.executable, __file__, "--one", path], stdout=f,
                               stderr=subprocess.STDOUT, text=True)
        lines = [l for l in log.read_text().splitlines() if l.startswith("STUDY ")]
        if p.returncode or not lines:
            failed = True
            print(f"{label}: failed (exit {p.returncode}), see {log}", flush=True)
            continue
        run = dict(label=label, tree=path, **json.loads(lines[-1][6:]))
        runs.append(run)
        brief = {k: run.get(k) for k in ("label", "fsdp", "mesh", "collective_ms")}
        print(json.dumps(brief), flush=True)
    (OUT / "summary.json").write_text(json.dumps(dict(card=smi, runs=runs), indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
