"""The engine's features on a ``(data, model)`` mesh (``ServeEngine(...,
mesh=)``, ``Router(mesh=)``): speculative decoding, the host-RAM tier with
hold and park, snapshots and request migration, against the reference's
engine on ``local_mesh`` of the same shape.

One spawn of 2 gloo ranks (``(1, 2)`` and ``(2, 1)``, two meshes over the
same processes), one of 4 (``(2, 2)``) and ``REF_PROCS`` processes of the
reference over 4 forced JAX host devices each start together (one torch
thread a rank; only the reference's processes import JAX; the ranks wait
for the weights the first writes).  Every scenario runs the same code in
both packages, on the fp32 smoke configs with the reference's weights:

* **tier**: ``test_torch_host_tier.py``'s fixed preempt/hold/park/release
  schedule, with a swap of two lanes' requests, on the slotted layout and on the paged one with
  ``admission="preempt"``, the prefix cache and a pool of 6 blocks;
* **spec**: ``smollm-360m`` (at every mesh) and ``gemma2-27b`` (at
  ``(2, 2)``) with a draft of the same config (the reference fuzzer's mix
  of the weights), both layouts;
* **spectier**: speculation on the tiered paged engine, lanes preempted
  mid-round, restored by copy and their drafts rebuilt;
* **snapshot**: ``snapshot`` after a few steps, restored into a fresh mesh
  engine and drained there (the port also through ``save_snapshot`` and
  ``restore_snapshot``: rank 0 writes, every rank reads);
* **migration**: two requests exported from one mesh engine and imported
  into another that shares its tier;
* **drain**: the router's ``drain`` at ``(1, 2)``, and the launcher's
  ``--mesh local`` with ``--spec-k``, two replicas and ``--drain-at``;
* ``zamba2-1.2b`` (the hybrid family, slotted): the tier schedule at
  ``(1, 2)`` and ``(2, 2)`` (a lane's payload its ``k``/``v`` positions and
  its whole recurrent leaves, moved as bytes where the swap crosses the
  data ranks), speculation with zamba2 as target and draft, a snapshot
  and a migration at ``(2, 2)``.

Held: the greedy streams, the counters and the tier's and speculation's
stats equal the reference engine's at the same mesh, on every rank, and
every rank's streams and stats equal; each rank's tier holds only its
share of every payload (summed over the ranks, the whole payloads, once a
model rank where the pool's kv heads do not split over ``model``) while
it reports the reference's whole bytes; at ``(2, 2)`` a restore lands on
another data rank than the one that spilled it (``COUNTS["tier_move"]``);
the default draft on a mesh is this rank's shards of the mesh-less
engine's init.
"""
import dataclasses
import gc
import json
import multiprocessing
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import init_group, mesh_from_group
from repro_torch.models import common

MAX_SLOTS, MAX_LEN, BS, SPEC_K = 4, 48, 8, 2
SHAPES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}     # the meshes of each spawn
ALL = SHAPES[2] + SHAPES[4]
LAYOUTS = {
    "slotted": dict(host_tier=True, park_idle_s=4.0),
    "paged": dict(kv_layout="paged", page_size=BS, num_blocks=6, admission="preempt",
                  prefix_cache=True, host_tier=True, park_idle_s=4.0),
}
SPEC_LAYOUTS = {"slotted": dict(), "paged": dict(kv_layout="paged", page_size=BS)}
SPEC_TIER = dict(kv_layout="paged", page_size=BS, num_blocks=6, admission="preempt",
                 host_tier=True)
MIGRATION = {"paged": dict(kv_layout="paged", page_size=BS, host_tier=True),
             "slotted": dict(host_tier=True)}
ZAMBA = "zamba2-1.2b"
SPEC_ARCHS = ("smollm-360m", "gemma2-27b", ZAMBA)
# (scenario, arch, layout, mesh shape)
RUNS = ([("tier", "smollm-360m", lay, sh) for lay in LAYOUTS for sh in ALL]
        + [("spec", "smollm-360m", lay, sh) for lay in SPEC_LAYOUTS for sh in ALL]
        + [("spec", "gemma2-27b", lay, (2, 2)) for lay in SPEC_LAYOUTS]
        + [("spectier", "smollm-360m", "paged", sh) for sh in ((1, 2), (2, 2))]
        + [("snapshot", "smollm-360m", lay, (2, 2)) for lay in ("slotted", "paged")]
        + [("migration", "smollm-360m", "paged", (2, 2)), ("drain", "gemma2-27b", "paged", (1, 2))]
        + [("tier", ZAMBA, "slotted", sh) for sh in ((1, 2), (2, 2))]
        + [(name, ZAMBA, "slotted", (2, 2)) for name in ("spec", "snapshot", "migration")])
# the counters both packages keep (the port adds ``prefill_first_chunks``
# and ``spec_draft_prefills``); ``kv_peak_used_bytes`` is the reference's
# global gauge and the port's a rank's
COUNTERS = ("prefills", "prefill_chunks", "decode_steps", "admitted", "evicted",
            "dead_slot_steps", "prefill_tokens", "prefix_lookup_tokens", "prefix_hit_tokens",
            "cow_copies", "preemptions", "resumed", "replayed_tokens", "status_ok",
            "snapshot_restores", "exported", "imported", "spills", "restores",
            "spilled_bytes", "restored_bytes", "spill_drops", "prefix_spills",
            "host_prefix_hits", "holds", "releases", "parked", "spec_steps", "spec_rounds",
            "spec_drafted", "spec_accepted", "spec_rejected", "spec_committed")
STATS = ("host_tier", "spec_acceptance_rate", "tokens_per_decode_dispatch",
         "prefix_cached_blocks", "prefix_cache_evictions", "prefix_hit_rate")
ROUTER_COUNTERS = ("submitted", "dispatched", "migrated", "failovers", "status_ok")


# ---------------------------------------------------------------------------
# The scenarios, the same code for both packages
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _stream(vocab, seed=5):
    """``test_torch_host_tier.py``'s five arrivals: (tick, prompt, budget)."""
    rng = np.random.default_rng(seed)
    out, tick = [], 0
    for _ in range(5):
        tick += int(rng.integers(0, 3))
        plen, budget = int(rng.integers(2, 20)), int(rng.integers(3, 8))
        out.append((tick, rng.integers(0, vocab, plen).astype(np.int32), budget))
    return out


def _prompts(vocab):
    """Six staggered prompts (``test_torch_serve_mesh.py``'s)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in (5, 9, 3, 12, 7, 4)]


# tick -> ops (``test_torch_host_tier.py``'s schedule, and a swap at tick
# 10): each acts on the first decoding lane (preempt: the last), release on
# the first held or parked request, idle moves the clock past the park
# threshold; swap preempts the first decoding lane and then the last, so
# the last resumes first, into the first's lane (on a mesh whose data axes
# split the lanes, another data rank's)
SCHEDULE = {2: ["preempt"], 3: ["hold"], 4: ["idle"], 5: ["preempt"], 6: ["hold"],
            8: ["release"], 9: ["idle", "hold"], 10: ["swap"], 11: ["release"],
            12: ["release"]}
PREEMPTS = {2: ["preempt"], 4: ["preempt"], 7: ["preempt"]}


def _decoding(eng):
    return [i for i, s in enumerate(eng.slots) if s is not None
            and s.prefilled >= s.plen and s.generated >= 1 and not s.held]


def _scheduled(schedule):
    def hook(eng, clock, tick):
        if tick > max(schedule):
            for s in list(eng.slots):
                if s is not None and s.held:
                    eng.release(s.rid)
            for rid in sorted(eng.parked):
                eng.release(rid)
            return
        for op in schedule.get(tick, ()):
            decoding = _decoding(eng)
            held = [s.rid for s in eng.slots if s is not None and s.held]
            if op == "preempt" and decoding:
                eng.preempt(decoding[-1])
            elif op == "swap" and len(decoding) > 1:
                eng.preempt(decoding[0])
                eng.preempt(decoding[-1])
            elif op == "hold" and decoding:
                eng.hold(eng.slots[decoding[0]].rid)
            elif op == "release" and (held or eng.parked):
                eng.release((held + sorted(eng.parked))[0])
            elif op == "idle":
                clock.t += 5.0
    return hook


def _drive(eng, clock, stream, hook=None, after=None):
    """Replay the arrivals through one engine; ``hook(eng, clock, tick)``
    before each step, the invariants and ``after(eng)`` after it."""
    i = tick = 0
    while i < len(stream) or eng.has_work():
        while i < len(stream) and stream[i][0] <= tick:
            eng.submit(stream[i][1], max_new_tokens=stream[i][2], rid=i)
            i += 1
        if hook is not None:
            hook(eng, clock, tick)
        eng.step()
        eng.check_invariants()
        if after is not None:
            after(eng)
        clock.t += 1.0
        tick += 1
        assert tick < 500, "engine failed to drain"
    return [list(eng.completions[r].tokens) for r in range(len(stream))]


def _record(eng):
    return {"counters": {k: int(eng.counters[k]) for k in COUNTERS},
            "stats": {k: eng.stats[k] for k in STATS if k in eng.stats}}


def _staggered(eng, prompts, new=8):
    rids = []
    for i, p in enumerate(prompts):
        rids.append(eng.submit(p, max_new_tokens=new))
        if i % 2:
            eng.step()
    eng.drain()
    return [list(eng.completions[r].tokens) for r in rids]


def scenario(name, layout, make, vocab, *, save=None, tier=None):
    """Run scenario ``name`` on ``layout`` with ``make(clock, **fields)``
    building an engine of either package (``tier()`` a fresh host tier of
    that package; ``save(eng, step) -> restored engine`` the port's
    checkpointed path of the snapshot, None in the reference).  Returns
    its streams and figures."""
    clock = FakeClock()
    if name == "tier":
        eng = make(clock, **LAYOUTS[layout])
        shares = []
        streams = _drive(eng, clock, _stream(vocab), _scheduled(SCHEDULE),
                         after=lambda e: shares.append(_held(e.tier)))
        return dict(streams=streams, shares=shares, **_record(eng))
    if name == "spec":
        eng = make(clock, spec_draft=True, **SPEC_LAYOUTS[layout])
        return dict(streams=_staggered(eng, _prompts(vocab)), **_record(eng))
    if name == "spectier":
        eng = make(clock, spec_draft=True, **SPEC_TIER)
        streams = _drive(eng, clock, _stream(vocab), _scheduled(PREEMPTS))
        return dict(streams=streams, **_record(eng))
    stream = _stream(vocab)
    if name == "snapshot":
        a = make(clock, **SPEC_LAYOUTS[layout])
        for i, (_, p, b) in enumerate(stream):
            a.submit(p, max_new_tokens=b, rid=i)
        for _ in range(4):
            a.step()
        snap = json.loads(json.dumps(a.snapshot()))
        b = make(clock, **SPEC_LAYOUTS[layout])
        b.restore(snap)
        _drive(b, clock, [])
        out = dict(streams=[list(b.completions[r].tokens) for r in range(len(stream))],
                   **_record(b))
        if save is not None:
            c = save(a, 4)
            _drive(c, FakeClock(), [])
            out["saved_streams"] = [list(c.completions[r].tokens) for r in range(len(stream))]
        return out
    if name == "migration":
        shared = tier()
        a = make(clock, host_tier_obj=shared, **MIGRATION[layout])
        b = make(clock, host_tier_obj=shared, **MIGRATION[layout])
        for i, (_, p, bud) in enumerate(stream):
            a.submit(p, max_new_tokens=bud + 4, rid=i)
        for _ in range(5):
            a.step()
        moved = [a.slots[_decoding(a)[0]].rid, next(r.rid for r in a.queue if not r.resume)]
        for r in moved:
            snap = json.loads(json.dumps(a.export_request(r)))
            b.import_request(snap, front=snap["pending"]["resume"])
        a.drain()
        b.drain()
        done = {**a.completions, **b.completions}
        return dict(streams=[list(done[r].tokens) for r in range(len(stream))], moved=moved,
                    a=_record(a), b=_record(b))
    raise ValueError(name)


def _held(tier):
    """(bytes this rank's tier holds, the bytes it reports)."""
    held = sum(int(t.nbytes) for sp in tier._lanes.values()
               for p in sp.blocks + ([sp.leaves] if sp.leaves is not None else [])
               for t in p.values())
    held += sum(int(t.nbytes) for p in tier._prefix.values() for t in p.values())
    return held, tier.used_bytes


def router_scenario(router, clock, vocab):
    """Six prompts behind a 2-replica router; replica 1 drained at tick 3."""
    rids = [router.submit(p, max_new_tokens=8) for p in _prompts(vocab)]
    tick = 0
    while router.has_work():
        if tick == 3:
            router.drain(1)
        router.step()
        clock.t += 1.0
        tick += 1
        assert tick < 500
    stats = router.stats
    return dict(streams=[list(router.completions[r].tokens) for r in rids],
                counters={k: int(stats[k]) for k in ROUTER_COUNTERS})


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                               attn_impl="kernel")


def _port_make(cfg, init, draft, mesh):
    from repro_torch.serve import EngineConfig, ServeEngine

    def make(clock, spec_draft=False, host_tier_obj=None, **fields):
        if spec_draft:
            fields.update(spec_draft=cfg, spec_k=SPEC_K)
        return ServeEngine(cfg, init, EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN,
                                                   **fields),
                           device="cpu", mesh=mesh, clock=clock, host_tier=host_tier_obj,
                           draft_params=draft if spec_draft else None)
    return make


def _port_run(mesh, key, init, draft, out_dir):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.serve import HostTier, Router, RouterConfig, ServeEngine

    name, arch, layout, shape = key
    cfg = _cfg(arch)
    common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
    if name == "drain":
        from repro_torch.serve import EngineConfig

        clock = FakeClock()
        router = Router(cfg, init, EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN,
                                                kv_layout="paged", page_size=BS),
                        RouterConfig(replicas=2), device="cpu", clock=clock, mesh=mesh)
        out = router_scenario(router, clock, cfg.vocab)
    else:
        make = _port_make(cfg, init, draft, mesh)

        def save(eng, step):
            mgr = CheckpointManager(str(out_dir / f"snap_{layout}_{shape[0]}x{shape[1]}"))
            eng.save_snapshot(mgr, step)
            fresh = make(FakeClock(), **SPEC_LAYOUTS[layout])
            assert fresh.restore_snapshot(mgr) == step
            return fresh

        out = scenario(name, layout, make, cfg.vocab, save=save, tier=HostTier)
    out["counts"] = dict(common.COUNTS)
    return out


def _default_draft_is_shards(mesh, init):
    """The default draft on the mesh: this rank's shards of the mesh-less
    engine's init from the engine seed."""
    from repro_torch.models import lm
    from repro_torch.optim.fsdp import shard_tree
    from repro_torch.serve import EngineConfig, ServeEngine
    from repro_torch.serve.engine import serve_shard_layout

    cfg = _cfg("gemma2-27b")
    ec = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, spec_draft=cfg, spec_k=SPEC_K,
                      seed=3)
    eng = ServeEngine(cfg, init, ec, device="cpu", mesh=mesh)
    want = shard_tree(serve_shard_layout(cfg, mesh), lm.init(cfg, seed=3, device="cpu"))
    got = eng.draft_params

    def flat(t, p=()):
        for k, v in t.items():
            yield from flat(v, p + (k,)) if isinstance(v, dict) else [(p + (k,), v)]
    return all(torch.equal(a, b) for (_, a), (_, b) in zip(flat(got), flat(want)))


# the launcher's features under ``--mesh local`` (its draft mixed from the
# rank's shards, two replicas, a drain); greedy streams are the one-device
# launcher's whatever the arrivals' timing
LAUNCH = ["--arch", "gemma2-27b", "--smoke", "--device", "cpu", "--kv-layout", "paged",
          "--replicas", "2", "--drain-at", "2", "--spec-k", "2", "--requests", "6",
          "--rate", "1000"]


def _launch(argv):
    import contextlib
    import io

    from repro_torch.launch import serve as launch

    with contextlib.redirect_stdout(io.StringIO()):
        router = launch.main(argv)
    return dict(streams={r: list(c.tokens) for r, c in router.completions.items()},
                status_ok=router.stats["status_ok"], migrated=router.stats["migrated"],
                spec_steps=sum(h.engine.counters["spec_steps"] for h in router.replicas))


def _worker(rank, world, address, out_dir, launch_port=None):
    torch.set_num_threads(1)
    group = init_group("gloo", rank, world, address, device="cpu", timeout_s=240)
    res = {}
    try:
        meshes = {shape: mesh_from_group(group, shape) for shape in SHAPES[world]}
        _wait_for(out_dir / "inits.done")
        load = lambda n: torch.load(out_dir / n, weights_only=False)
        weights = {a: (load(f"{a}_init.pt"), load(f"{a}_draft.pt")) for a in SPEC_ARCHS}
        for key in RUNS:
            if key[3] in meshes:
                res[key] = _port_run(meshes[key[3]], key, *weights[key[1]], out_dir)
        if world == 2:
            res["default_draft"] = _default_draft_is_shards(meshes[(1, 2)],
                                                            weights["gemma2-27b"][0])
        dist.barrier()
    finally:
        group.close()
        del group
        gc.collect()
    if launch_port is not None:
        # the launcher's own group, as torchrun describes it
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(launch_port))
        res["launcher"] = _launch(LAUNCH + ["--mesh", "local"])
    torch.save(res, out_dir / f"w{world}_rank{rank}.pt")


def _wait_for(path, timeout_s=240.0):
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------


REF_PROCS = 4                          # reference processes, the runs split over them


def _reference(out_dir, part):
    """Part ``part`` of the reference's runs, in a process of its own over
    4 forced host devices: part 0 writes the weights first (the target's
    init and the reference fuzzer's draft mix, converted)."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.mesh import local_mesh
    from repro.models import registry as jreg
    from repro.models.common import ShardRules as JRules
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import HostTier as JHostTier
    from repro.serve import Router as JRouter
    from repro.serve import RouterConfig as JRouterConfig
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.models.convert import params_from_numpy

    assert jax.device_count() == 4
    jcfgs = {a: dataclasses.replace(jax_smoke(a), compute_dtype="float32") for a in SPEC_ARCHS}
    weights = {}
    for a, jcfg in jcfgs.items():
        mod = jreg.get_module(jcfg)
        jp = mod.init(jcfg, jax.random.PRNGKey(0))
        noise = mod.init(jcfg, jax.random.PRNGKey(1))
        # zamba2's draft closer to its target (as chip_smoke's 5d): at 0.15
        # its smoke draft proposes nothing the target accepts
        alpha = 0.02 if a == ZAMBA else 0.15
        jd = jax.tree.map(lambda x, y: (1 - alpha) * x + alpha * y, jp, noise)
        weights[a] = (jp, jd)
        if part == 0:
            for name, t in (("init", jp), ("draft", jd)):
                torch.save(params_from_numpy(_cfg(a), jax.tree.map(np.asarray, t),
                                             device="cpu"), out_dir / f"{a}_{name}.pt")
    if part == 0:
        (out_dir / "inits.done").touch()
    out = {}
    for key in RUNS[part::REF_PROCS]:
        name, arch, layout, shape = key
        mesh = local_mesh(data=shape[0], model=shape[1])
        rules = JRules.for_mesh(mesh)
        jcfg, (jp, jd) = jcfgs[arch], weights[arch]
        if name == "drain":
            clock = FakeClock()
            router = JRouter(jcfg, mesh, rules, jp, JEngineConfig(
                max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged", page_size=BS),
                JRouterConfig(replicas=2), clock=clock)
            out[key] = router_scenario(router, clock, jcfg.vocab)
            continue

        def make(clock, spec_draft=False, host_tier_obj=None, **fields):
            if spec_draft:
                fields.update(spec_draft=jcfg, spec_k=SPEC_K)
            return JServeEngine(jcfg, mesh, rules, jp, JEngineConfig(
                max_slots=MAX_SLOTS, max_len=MAX_LEN, **fields), clock=clock,
                host_tier=host_tier_obj, draft_params=jd if spec_draft else None)
        out[key] = scenario(name, layout, make, jcfg.vocab, tier=JHostTier)
        out[key].pop("shares", None)
    torch.save(out, out_dir / f"reference{part}.pt")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Start the 2 ranks, the 4 ranks and the reference together; returns
    ({world: [rank results]}, the reference's results, seconds taken)."""
    t0 = time.monotonic()
    out_dir = tmp_path_factory.mktemp("serve_mesh_features")
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for world in SHAPES:
        address = f"tcp://127.0.0.1:{_free_port()}"
        launch_port = _free_port() if world == 2 else None
        procs += [ctx.Process(target=_worker, args=(r, world, address, out_dir, launch_port))
                  for r in range(world)]
    old = os.environ.get("XLA_FLAGS")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    try:
        procs += [ctx.Process(target=_reference, args=(out_dir, i)) for i in range(REF_PROCS)]
        for p in procs:
            p.start()
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS")
        else:
            os.environ["XLA_FLAGS"] = old
    for p in procs:
        p.join(timeout=400)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a process hung"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    load = lambda name: torch.load(out_dir / name, weights_only=False)
    ranks = {w: [load(f"w{w}_rank{r}.pt") for r in range(w)] for w in SHAPES}
    ref = {}
    for i in range(REF_PROCS):
        ref.update(load(f"reference{i}.pt"))
    return ranks, ref, time.monotonic() - t0


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


def _runs_of(ranks, key):
    shape = key[3]
    return [r[key] for r in ranks[shape[0] * shape[1]]]


def _same_on_every_rank(runs):
    for other in runs[1:]:
        assert {k: v for k, v in other.items() if k not in ("shares", "counts")} == \
            {k: v for k, v in runs[0].items() if k not in ("shares", "counts")}
        assert other["counts"] == runs[0]["counts"]


def _ids(runs):
    return [f"{n}-{a}-{lay}-{s[0]}x{s[1]}" for n, a, lay, s in runs]


TIER_RUNS = [k for k in RUNS if k[0] == "tier"]
SPEC_RUNS = [k for k in RUNS if k[0] in ("spec", "spectier")]


@pytest.mark.parametrize("key", TIER_RUNS, ids=_ids(TIER_RUNS))
def test_tier_schedule_matches_reference(spawned, key):
    """The fixed preempt/hold/park/release schedule: streams, counters and
    the tier's stats (``used_bytes`` the whole payloads') the reference
    engine's at the same mesh, on every rank; every rank's tier holds its
    share, the whole payloads over the ranks at every step."""
    ranks, ref, _ = spawned
    runs, want = _runs_of(ranks, key), ref[key]
    got = runs[0]
    assert got["streams"] == want["streams"]
    assert got["counters"] == want["counters"] and got["stats"] == want["stats"]
    _same_on_every_rank(runs)
    c = got["counters"]
    assert c["spills"] > 0 and c["restores"] > 0 and c["holds"] > 0 and c["parked"] > 0
    assert c["replayed_tokens"] == 0
    _, arch, layout, (data, model) = key
    cfg = _cfg(arch)
    # each payload is held once over the ranks, by its data rank, split
    # over model where the layout splits it (a slotted lane's positions,
    # the pool's kv heads where they divide), else whole on each model rank
    # (the pool's kv heads where they do not; a hybrid lane's recurrent
    # leaves)
    copies = model if layout == "paged" and cfg.n_kv % model else 1
    if cfg.family == "hybrid":
        from repro_torch.models import ssm, zamba

        kv = 2 * zamba.n_shared_invocations(cfg) * MAX_LEN * cfg.n_kv * cfg.head_dim
        _, H, conv_ch = ssm.mamba_dims(cfg)
        rec = cfg.n_layers * (H * cfg.ssm.state * cfg.ssm.head_dim
                              + (cfg.ssm.conv_kernel - 1) * conv_ch)
        copies = (kv + model * rec) / (kv + rec)
    for step, per_rank in enumerate(zip(*(r["shares"] for r in runs))):
        used = per_rank[0][1]
        assert all(u == used for _, u in per_rank), step
        assert sum(h for h, _ in per_rank) == copies * used, (step, per_rank)
        if data > 1 and used:
            assert all(h <= used for h, _ in per_rank)


def test_a_restore_crosses_data_ranks(spawned):
    """At (2, 2) a restore lands on a lane or blocks of another data rank
    than the one that spilled them: its payload moves (the transport's
    broadcast), on both layouts' schedules."""
    ranks, _, _ = spawned
    moves = {(arch, layout): _runs_of(ranks, ("tier", arch, layout, (2, 2)))[0]["counts"]
             ["tier_move"] for arch, layout in [("smollm-360m", lay) for lay in LAYOUTS]
             + [(ZAMBA, "slotted")]}
    assert all(n > 0 for n in moves.values()), moves


@pytest.mark.parametrize("key", SPEC_RUNS, ids=_ids(SPEC_RUNS))
def test_spec_matches_reference(spawned, key):
    """Speculation on the mesh, the draft under its own mesh program (its
    cache slotted over the data axes even under a paged target): streams,
    counters and the spec stats the reference's at the same mesh; with the
    tier, preempted lanes restore by copy (no replay) and rebuild their
    draft."""
    ranks, ref, _ = spawned
    runs, want = _runs_of(ranks, key), ref[key]
    got = runs[0]
    assert got["streams"] == want["streams"]
    assert got["counters"] == want["counters"] and got["stats"] == want["stats"]
    _same_on_every_rank(runs)
    c = got["counters"]
    assert c["spec_steps"] == c["decode_steps"] > 0 and c["spec_committed"] > c["spec_rounds"]
    if key[0] == "spectier":
        assert c["preemptions"] > 0 and c["restores"] > 0 and c["replayed_tokens"] == 0


@pytest.mark.parametrize("arch,layout", [("smollm-360m", "slotted"), ("smollm-360m", "paged"),
                                         (ZAMBA, "slotted")],
                         ids=["slotted", "paged", f"{ZAMBA}-slotted"])
def test_snapshot_restores_on_a_fresh_mesh_engine(spawned, arch, layout):
    """``snapshot`` after four steps, restored into a fresh (2, 2) engine
    and drained: the reference's streams and counters; the port's
    ``save_snapshot``/``restore_snapshot`` (rank 0 writes, a barrier,
    every rank reads) gives the same streams."""
    ranks, ref, _ = spawned
    key = ("snapshot", arch, layout, (2, 2))
    runs, want = _runs_of(ranks, key), ref[key]
    got = runs[0]
    assert got["streams"] == want["streams"] and got["counters"] == want["counters"]
    assert got["saved_streams"] == got["streams"]
    assert got["counters"]["snapshot_restores"] == 1
    _same_on_every_rank(runs)


@pytest.mark.parametrize("arch,layout", [("smollm-360m", "paged"), (ZAMBA, "slotted")],
                         ids=["smollm-360m-paged", f"{ZAMBA}-slotted"])
def test_migration_between_mesh_engines_sharing_a_tier(spawned, arch, layout):
    """Two requests exported from one (2, 2) engine (one on a lane, one
    queued) and imported into another sharing the tier: the moved lane
    restores by copy there; streams and both engines' counters the
    reference's."""
    ranks, ref, _ = spawned
    key = ("migration", arch, layout, (2, 2))
    runs, want = _runs_of(ranks, key), ref[key]
    got = runs[0]
    assert got["streams"] == want["streams"] and got["moved"] == want["moved"]
    assert got["a"] == want["a"] and got["b"] == want["b"]
    assert got["a"]["counters"]["exported"] == 2 == got["b"]["counters"]["imported"]
    assert got["b"]["counters"]["restores"] == 1
    _same_on_every_rank(runs)


def test_router_drain_on_the_mesh(spawned):
    """The router's ``drain`` at (1, 2): the drained replica's requests
    migrate to the other and finish; streams and the router's counters
    the reference router's, on both ranks."""
    ranks, ref, _ = spawned
    key = ("drain", "gemma2-27b", "paged", (1, 2))
    runs, want = _runs_of(ranks, key), ref[key]
    assert runs[0]["streams"] == want["streams"] and runs[0]["counters"] == want["counters"]
    assert runs[0]["counters"]["migrated"] > 0 and runs[0]["counters"]["status_ok"] == 6
    _same_on_every_rank(runs)


def test_launcher_features_on_a_mesh(spawned):
    """``--mesh local`` over 2 gloo ranks with ``--spec-k``, ``--replicas 2``
    and ``--drain-at``: every request ``ok`` with the one-device launcher's
    greedy stream (its draft the same mix), on both ranks alike."""
    ranks, _, _ = spawned
    want = _launch(LAUNCH + ["--mesh", "single"])
    got = [r["launcher"] for r in ranks[2]]
    assert got[0]["streams"] == want["streams"] and got[0]["status_ok"] == 6
    assert got[0]["spec_steps"] > 0
    assert got[1] == got[0]


def test_default_draft_is_the_ranks_shards(spawned):
    """With no ``draft_params`` the mesh engine's draft is this rank's
    shards of the init the mesh-less engine draws from its seed."""
    ranks, _, _ = spawned
    assert all(r["default_draft"] for r in ranks[2])
