"""Serving the ``lm`` family on a ``(data, model)`` mesh (``ServeEngine(...,
mesh=)``), against the reference's engine on ``local_mesh`` of the same
shape.

One spawn of 2 gloo ranks (``(1, 2)`` and ``(2, 1)``, two meshes over the
same processes), one of 4 (``(2, 2)``) and four processes of the
reference over 4 forced JAX host devices each (the reference's engine
runs split over them: each compiles its programs in some 4 s) start
together (one torch thread a rank; only the reference's processes import
JAX; the ranks wait for the inits the first writes).  Each rank serves six
staggered prompts of the fp32 smoke configs of ``smollm-360m`` (3/1
heads: they do not divide over 2, so every rank attends every head),
``gemma2-27b`` and ``qwen3-moe-30b-a3b`` (4/2 heads: local heads, local
experts) on both KV layouts, fused sampling for the streams and host
sampling for the decode logits, and holds:

* the greedy streams equal to the reference engine's at the same mesh
  (MoE at a data axis of 2 against the reference's ``(1, 2)``: the
  reference's MoE raises at a data axis above 1, a batch-1 prefill not
  dividing over it), and the logits of every occupied lane within 1e-4;
* every rank's streams and ``stats`` equal;
* ``kv_reserved_bytes`` a rank equal to the reference's bytes a device
  at the same mesh (its state specs' shard shapes; for MoE at a data axis
  of 2 the specs alone): a data rank holds its share of the lanes
  (slotted) or of the pool's blocks (paged);
* the batch fallback (``smollm-360m/slots3``: 3 lanes do not divide over
  a data axis of 2, so every rank holds every lane and its positions
  split over all 4 ranks) at ``(2, 2)``;
* a chunked prefill with the prefix cache (gemma2, paged) at ``(1, 2)``,
  and at ``(2, 2)`` over a pool of 12 blocks, 6 a data rank, where the
  copy-on-write moves a block from one data rank to the other and each
  continuation chunk gathers its lane over the data axis; qwen3-moe with
  one kv head (its q heads divide over 2, its kv heads do not: the paged
  decode attends a head run of the replicated pool);
* the sequence-sharded ``decode_attention`` at 2 ranks against the
  reference's under ``DecodeSharding`` on 2 devices: scalar and vector
  positions, a window, a softcap, writes on either rank's shard;
* the static loop at ``(1, 2)`` and ``(2, 1)`` (its batch split over the
  data axis);
* ``zamba2-1.2b`` (the hybrid family) at ``(1, 2)``, ``(2, 1)`` and
  ``(2, 2)``, its batch fallback (``zamba2-1.2b/slots3``) at ``(2, 2)``,
  its static loop and its router at ``(1, 2)``: its cache the reference's
  ``cache_pspec`` (``k``/``v`` lanes over the data axes and positions over
  ``model``, ``ssm``/``conv`` lanes over the data axes and whole over
  ``model``), each Mamba2 block every head on every model rank.

In this process: ``(1, 1)`` over a one-rank gloo group bitwise equal to
``mesh=None`` (streams, logits, bytes, counters), and so are the engine's
features there (speculation, the host tier with hold and park, snapshots,
migration; their multi-rank runs are ``test_torch_serve_mesh_features.py``'s),
the refusals, the cache layouts' local shapes and the launcher's
``--mesh``.
"""
import dataclasses
import gc
import multiprocessing
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import DataGroup, MeshGroup, init_group, mesh_from_group
from repro_torch.models import attention as tattn
from repro_torch.models import common, lm
from repro_torch.serve import EngineConfig, ServeEngine

ARCHS = ("smollm-360m", "gemma2-27b", "qwen3-moe-30b-a3b")
MOE = "qwen3-moe-30b-a3b"
KV1 = "qwen3-moe-30b-a3b/kv1"          # one kv head: the q heads divide over 2, it does not
ZAMBA = "zamba2-1.2b"                   # the hybrid family: slotted only
LAYOUTS = ("slotted", "paged")
SLOTS3 = "smollm-360m/slots3"           # 3 lanes: the batch fallback at a data axis of 2
ZSLOTS3 = "zamba2-1.2b/slots3"
CHUNK12 = "gemma2-27b/chunk12"         # chunks and prefix cache over 12 blocks, 6 a data rank
# (variant, layout, mesh shape) runs of the ranks; the reference's mesh is
# the same but for MoE at a data axis of 2
RUNS = ([(a, lay, (1, 2)) for a in ARCHS for lay in LAYOUTS]
        + [(a, lay, (2, 1)) for a in ARCHS for lay in LAYOUTS]
        + [(a, lay, (2, 2)) for a in ARCHS for lay in LAYOUTS]
        + [(KV1, lay, (1, 2)) for lay in LAYOUTS] + [("gemma2-27b/chunk", "paged", (1, 2))]
        + [(SLOTS3, "slotted", (2, 2)), (CHUNK12, "paged", (2, 2))]
        + [(ZAMBA, "slotted", sh) for sh in ((1, 2), (2, 1), (2, 2))]
        + [(ZSLOTS3, "slotted", (2, 2))])
SHAPES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}     # the meshes of each spawn
NEW = 8


def _ref_shape(variant, shape):
    return (1, 2) if variant.startswith(MOE) else shape


def _arch(variant):
    return variant.split("/")[0]


def _cfg(variant, dtype="float32"):
    cfg = dataclasses.replace(get_smoke_config(_arch(variant)), compute_dtype=dtype,
                              attn_impl="kernel")
    return dataclasses.replace(cfg, n_kv=1) if variant == KV1 else cfg


def _jax_cfg(variant):
    from repro.configs import get_smoke_config as jax_smoke

    cfg = dataclasses.replace(jax_smoke(_arch(variant)), compute_dtype="float32")
    return dataclasses.replace(cfg, n_kv=1) if variant == KV1 else cfg


def _econ(variant, layout, fused=True):
    kw = dict(max_slots=4, max_len=32, page_size=8, kv_layout=layout, fused_sampling=fused)
    if variant.endswith(("/chunk", "/chunk12")):
        kw.update(prefill_chunk=4, prefix_cache=True)
    if variant == CHUNK12:
        kw.update(num_blocks=12)
    if variant.endswith("/slots3"):
        kw.update(max_slots=3)
    return kw


def _prompts(variant, vocab):
    rng = np.random.default_rng(0)
    ps = [rng.integers(0, vocab, int(n)).astype(np.int32) for n in (5, 9, 3, 12, 7, 4)]
    if variant.endswith(("/chunk", "/chunk12")):
        # shared 8- and 12-token prefixes: whole-block prefix hits, a COW tail
        ps = [np.concatenate([ps[3][:8], p])[:12] for p in ps[:3]] + [ps[3], ps[3][:8]] + ps[4:5]
    return ps


def _serve(variant, layout, eng):
    """Six prompts submitted two a step, drained; returns the streams."""
    prompts = _prompts(variant, eng.cfg.vocab)
    rids = []
    for i, p in enumerate(prompts):
        rids.append(eng.submit(p, max_new_tokens=NEW))
        if i % 2:
            eng.step()
    eng.drain()
    return [list(eng.completions[r].tokens) for r in rids]


def _recording(eng):
    """Wrap the engine's host sampler to keep each call's logits and which
    lanes were occupied."""
    seen = []
    inner = eng._host_sample

    def rec(logits, *a, **k):
        occ = [s is not None for s in eng.slots] if logits.shape[0] > 1 else [True]
        seen.append((np.asarray(logits, np.float32).copy(), occ))
        return inner(logits, *a, **k)
    eng._host_sample = rec
    return seen


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _dec_case(i):
    """Inputs of decode-attention case ``i``: q (4, 2, 2, 16), a cache of 16
    positions, the new k/v, the positions and the options."""
    rng = np.random.default_rng(50 + i)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    cases = [(np.int32(5), 0, 0.0), (np.int32(11), 4, 30.0),
             (np.array([0, 7, 8, 15], np.int32), 6, 0.0),
             (np.array([3, 12, 9, 1], np.int32), 0, 20.0)]
    idx, window, cap = cases[i]
    return dict(q=f(4, 2, 2, 16), kc=f(4, 16, 2, 16), vc=f(4, 16, 2, 16), kn=f(4, 2, 16),
                vn=f(4, 2, 16), idx=idx, window=window, softcap=cap)


N_DEC = 4


def _decode_attention_checks(mesh):
    g = mesh.model
    out = []
    for i in range(N_DEC):
        c = _dec_case(i)
        half = lambda x: torch.tensor(x).narrow(1, g.rank * 8, 8).clone()
        kc, vc = half(c["kc"]), half(c["vc"])
        common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
        o = tattn.decode_attention(torch.tensor(c["q"]), kc, vc, torch.tensor(c["kn"]),
                                   torch.tensor(c["vn"]), torch.tensor(c["idx"]),
                                   window=c["window"], softcap=c["softcap"], seq_group=g)
        out.append(dict(o=o, kc=kc, vc=vc, combine=common.COUNTS["decode_combine"]))
    return out


def _port_run(mesh, variant, layout, init):
    cfg = _cfg(variant)
    eng = ServeEngine(cfg, init, EngineConfig(**_econ(variant, layout)), device="cpu",
                      mesh=mesh)
    common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
    streams = _serve(variant, layout, eng)
    counts = dict(common.COUNTS)
    stats = eng.stats
    host = ServeEngine(cfg, init, EngineConfig(**_econ(variant, layout, fused=False)),
                       device="cpu", mesh=mesh)
    seen = _recording(host)
    host_streams = _serve(variant, layout, host)
    return dict(streams=streams, stats=stats, host_streams=host_streams, logits=seen,
                kv_bytes=eng.kv_reserved_bytes, counts=counts,
                cache_shapes={n: tuple(c.shape) for n, c in eng.state["cache"].items()})


def _router_run(mesh, init, variant="gemma2-27b", layout="paged"):
    """``variant``'s engine behind a 2-replica router on the mesh: the
    launcher's path (placement imports each request into a replica)."""
    from repro_torch.serve import Router, RouterConfig

    router = Router(_cfg(variant), init, EngineConfig(**_econ(variant, layout)),
                    RouterConfig(replicas=2), device="cpu", mesh=mesh)
    rids = [router.submit(p, max_new_tokens=NEW) for p in _prompts(variant, 256)]
    router.run()
    stats = {k: v for k, v in router.stats.items() if k != "tick"}
    return dict(streams=[list(router.completions[r].tokens) for r in rids], stats=stats,
                placements=dict(router.placements), tick=router.tick)


STATIC = ("gemma2-27b", "internvl2-76b", ZAMBA)


def _static_inputs(arch):
    """The static loop's batch: 2 prompts of 6 tokens (and the VLM's patch
    embeddings), fp32 weights from the port's own init."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    extra = None
    if cfg.family == "vlm":
        extra = rng.normal(size=(2, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return cfg, registry_init(cfg), prompts, extra


def _static_runs(mesh=None):
    """``generate_static`` of each ``STATIC`` config, on ``mesh``; the
    logits of each step kept (the family module's ``decode_step``
    wrapped)."""
    from repro_torch.models import registry
    from repro_torch.serve import ServeConfig, generate_static

    out = {}
    for arch in STATIC:
        cfg, init, prompts, extra = _static_inputs(arch)
        mod = registry.get_module(cfg)
        seen = []
        inner = mod.decode_step

        def step(*a, **k):
            logits, cache = inner(*a, **k)
            seen.append(logits.detach().clone())
            return logits, cache
        mod.decode_step = step
        try:
            toks = generate_static(cfg, init, prompts, ServeConfig(max_new_tokens=6),
                                   extra=extra, device="cpu", mesh=mesh)
        finally:
            mod.decode_step = inner
        out[arch] = (toks, seen)
    return out


def _worker(rank, world, address, out_dir):
    torch.set_num_threads(1)
    group = init_group("gloo", rank, world, address, device="cpu", timeout_s=240)
    res = {}
    try:
        meshes = {shape: mesh_from_group(group, shape) for shape in SHAPES[world]}
        if world == 2:
            res["decode_attention"] = _decode_attention_checks(meshes[(1, 2)])
            res["static"] = {shape: _static_runs(m) for shape, m in meshes.items()}
        _wait_for(out_dir / "inits.done")
        for variant, layout, sh in RUNS:
            if sh not in meshes:
                continue
            init = torch.load(out_dir / f"{variant.replace('/', '_')}_init.pt",
                              weights_only=False)
            res[(variant, layout, sh)] = _port_run(meshes[sh], variant, layout, init)
        if world == 2:
            res["router"] = _router_run(meshes[(1, 2)],
                                        torch.load(out_dir / "gemma2-27b_init.pt",
                                                   weights_only=False))
            res["zamba_router"] = _router_run(
                meshes[(1, 2)], torch.load(out_dir / f"{ZAMBA}_init.pt", weights_only=False),
                ZAMBA, "slotted")
        torch.save(res, out_dir / f"w{world}_rank{rank}.pt")
        dist.barrier()
    finally:
        group.close()
        del group
        gc.collect()


def _wait_for(path, timeout_s=240.0):
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------


REF_PROCS = 4                          # reference processes, the engine runs split over them


def _ref_runs():
    """The reference's engine runs: each (variant, layout, its mesh) once."""
    out = []
    for variant, layout, shape in RUNS:
        key = (variant, layout, _ref_shape(variant, shape))
        if key not in out:
            out.append(key)
    return out


def _reference(out_dir, part):
    """Part ``part`` of the reference's work, in a process of its own over 4
    forced host devices: part 0 writes the inits first and runs
    ``decode_attention`` at (1, 2); every part runs its share of the engine
    runs on ``local_mesh`` of each run's shape (host sampling: its logits
    and its streams, the fused path's at a fixed seed)."""
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import local_mesh
    from repro.models import attention as jattn
    from repro.models import registry as jreg
    from repro.models.common import ShardRules as JRules
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import ServeEngine as JServeEngine
    from repro.serve import step as jstep
    from repro_torch.models.convert import params_from_numpy

    assert jax.device_count() == 4
    runs = _ref_runs()[part::REF_PROCS]
    variants = sorted({v for v, _, _ in RUNS}) if part == 0 else sorted({v for v, _, _ in runs})
    jparams = {v: jreg.get_module(_jax_cfg(v)).init(_jax_cfg(v), jax.random.PRNGKey(0))
               for v in variants}
    if part == 0:
        for v, jp in jparams.items():
            torch.save(params_from_numpy(_cfg(v), jax.tree.map(np.asarray, jp), device="cpu"),
                       out_dir / f"{v.replace('/', '_')}_init.pt")
        (out_dir / "inits.done").touch()
    out = {}
    if part == 0:
        dec = jattn.DecodeSharding.choose(local_mesh(data=1, model=2), 4)
        out["decode_sharding"] = (dec.batch_axes, dec.seq_axes)
        out["decode_attention"] = []
        for i in range(N_DEC):
            c = _dec_case(i)
            fn = jax.jit(lambda q, kc, vc, kn, vn, idx, c=c: jattn.decode_attention(
                q, kc, vc, kn, vn, idx, sharding=dec, window=c["window"],
                softcap=c["softcap"]))
            o, kc, vc = fn(*(jnp.asarray(c[k]) for k in ("q", "kc", "vc", "kn", "vn", "idx")))
            out["decode_attention"].append(dict(o=np.asarray(o), kc=np.asarray(kc),
                                                vc=np.asarray(vc)))
    # the engine's host sampler is its ``sample_tokens`` on the host's
    # logits, op by op (~0.45 s a step on 4 host devices); the same
    # function compiled once serves here
    sample = jax.jit(lambda lg, key, t, k, p: jstep.sample_tokens(lg, key, t, top_ks=k,
                                                                  top_ps=p))

    def host_sample(logits, sub, temps, top_ks, top_ps):
        return np.asarray(sample(jnp.asarray(logits, jnp.float32), sub,
                                 jnp.asarray(temps, jnp.float32), jnp.asarray(top_ks, jnp.int32),
                                 jnp.asarray(top_ps, jnp.float32)))

    if part == 0:
        out["kv_bytes_per_device"] = {(v, lay, sh): _ref_kv_bytes(v, lay, sh)
                                      for v, lay, sh in RUNS}
    for variant, layout, rshape in runs:
        mesh = local_mesh(data=rshape[0], model=rshape[1])
        jcfg = _jax_cfg(variant)
        eng = JServeEngine(jcfg, mesh, JRules.for_mesh(mesh), jparams[variant],
                           JEngineConfig(**_econ(variant, layout, fused=False)))
        eng._host_sample = host_sample
        seen = _recording(eng)
        streams = _serve(variant, layout, eng)
        per_device = sum(x.addressable_shards[0].data.nbytes
                         for x in jax.tree.leaves(eng.state["cache"]))
        out[(variant, layout, rshape)] = dict(
            streams=streams, logits=seen, kv_bytes_per_device=int(per_device),
            counters={k: int(eng.counters[k]) for k in ("prefills", "prefill_chunks",
                                                         "decode_steps", "admitted",
                                                         "evicted", "prefill_tokens",
                                                         "prefix_hit_tokens", "cow_copies")})
    torch.save(out, out_dir / f"reference{part}.pt")


def _ref_kv_bytes(variant, layout, shape):
    """The reference's KV bytes a device of ``variant``'s engine at
    ``shape``: its state specs' shard shape on ``local_mesh`` of that
    shape, the pool rounded up to the data size as its engine rounds it
    (for MoE at a data axis of 2, where its engine does not run)."""
    from repro.launch.mesh import local_mesh
    from repro.serve.cache import slot_state_specs
    from repro.serve.paged import paged_state_specs

    mesh = local_mesh(data=shape[0], model=shape[1])
    e = _econ(variant, layout)
    if layout == "slotted":
        sds, sh = slot_state_specs(_jax_cfg(variant), mesh, e["max_slots"], e["max_len"])
    else:
        want = e.get("num_blocks") or e["max_slots"] * (e["max_len"] // e["page_size"]) + 1
        nb = -(-want // shape[0]) * shape[0]
        sds, sh = paged_state_specs(_jax_cfg(variant), mesh, e["max_slots"], e["max_len"], nb,
                                    e["page_size"])
    return int(sum(np.prod(sh["cache"][k].shard_shape(x.shape)) * x.dtype.itemsize
                   for k, x in sds["cache"].items()))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Start the 2 ranks, the 4 ranks and the reference together; returns
    ({world: [rank results]}, the reference's results, seconds taken)."""
    t0 = time.monotonic()
    out_dir = tmp_path_factory.mktemp("serve_mesh")
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for world in SHAPES:
        address = f"tcp://127.0.0.1:{_free_port()}"
        procs += [ctx.Process(target=_worker, args=(r, world, address, out_dir))
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
    ranks = {w: [load(f"w{w}_rank{r}.pt") for r in range(w)] for w in (2, 4)}
    ref = {}
    for i in range(REF_PROCS):
        ref.update(load(f"reference{i}.pt"))
    return ranks, ref, time.monotonic() - t0


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


def _ranks_of(ranks, shape):
    return ranks[shape[0] * shape[1]]


@pytest.mark.parametrize("variant,layout,shape", RUNS,
                         ids=[f"{v}-{lay}-{s[0]}x{s[1]}" for v, lay, s in RUNS])
def test_mesh_engine_matches_reference(spawned, variant, layout, shape):
    ranks, ref, _ = spawned
    want = ref[(variant, layout, _ref_shape(variant, shape))]
    runs = [r[(variant, layout, shape)] for r in _ranks_of(ranks, shape)]
    got = runs[0]
    assert got["streams"] == want["streams"], (variant, layout, shape)
    assert got["host_streams"] == want["streams"]
    assert all(len(s) == NEW for s in got["streams"])
    # every rank: the same streams and stats
    for other in runs[1:]:
        assert other["streams"] == got["streams"] and other["stats"] == got["stats"]
        assert other["host_streams"] == got["host_streams"]
    assert got["stats"]["mesh"] == f"(data {shape[0]}, model {shape[1]})"
    for k, n in want["counters"].items():
        assert got["stats"][k] == n, k
    # the logits of every occupied lane, every prefill and decode step
    assert len(got["logits"]) == len(want["logits"])
    for (a, occ_a), (b, occ_b) in zip(got["logits"], want["logits"]):
        assert occ_a == occ_b and a.shape == b.shape
        rows = [i for i, o in enumerate(occ_a) if o]
        np.testing.assert_allclose(a[rows], b[rows], rtol=1e-4, atol=1e-4)
    # the data axis's collectives, the same on every rank
    counts = got["counts"]
    assert all(r["counts"] == counts for r in runs)
    slotted, lanes_split = layout == "slotted", not variant.endswith("/slots3")
    assert (counts["data_all_gather"] > 0) == (slotted and lanes_split)
    assert (counts["decode_combine"] > 0) == slotted
    assert (counts["data_combine"] > 0) == (not slotted)
    if variant == CHUNK12:
        # the copy-on-write crosses the data ranks; the continuations gather
        assert counts["block_copy"] == got["stats"]["cow_copies"] == 1
        assert counts["block_gather"] > 0


@pytest.mark.parametrize("shape", SHAPES[2], ids=["1x2", "2x1"])
def test_static_loop_on_the_mesh(spawned, shape):
    """``generate_static`` at (1, 2) and (2, 1) (the batch of 2 split over
    the data axis: each rank prefills and decodes its row, the logits
    gathered), gemma2 and the VLM backbone (its patch embeddings
    prepended, whole on every rank as the text is): the tokens of the
    mesh-less loop (held against the reference by
    ``test_torch_gemma2.py``, ``test_torch_vlm.py``) and each decode step's
    logits within 1e-4, on both ranks."""
    ranks, _, _ = spawned
    want = _static_runs()
    for r in ranks[2]:
        for arch in STATIC:
            toks, seen = r["static"][shape][arch]
            np.testing.assert_array_equal(toks, want[arch][0])
            assert len(seen) == len(want[arch][1]) == 6
            for a, b in zip(seen, want[arch][1]):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,key", [("router", ("gemma2-27b", "paged", (1, 2))),
                                      ("zamba_router", (ZAMBA, "slotted", (1, 2)))],
                         ids=["gemma2-27b", ZAMBA])
def test_router_on_the_mesh_matches_reference(spawned, name, key):
    """Two replicas behind the router at (1, 2), as the launcher runs them
    (gemma2 paged, zamba2 slotted): the streams the reference's engine
    gives, both ranks' placements, ticks and stats equal (one clock, one
    schedule)."""
    ranks, ref, _ = spawned
    got = [r[name] for r in ranks[2]]
    assert got[0]["streams"] == ref[key]["streams"]
    assert got[0]["stats"]["status_ok"] == 6 and len(set(got[0]["placements"].values())) == 2
    assert got[1] == got[0]


@pytest.mark.parametrize("variant,layout,shape", RUNS,
                         ids=[f"{v}-{lay}-{s[0]}x{s[1]}" for v, lay, s in RUNS])
def test_kv_bytes_a_rank_follow_reference_layout(spawned, variant, layout, shape):
    """The bytes a rank holds equal the reference's bytes a device at the
    same mesh: a data rank's share of the lanes (slotted: ``max_slots /
    data`` lanes of ``max_len / model`` positions, or under the batch
    fallback every lane with ``max_len / world`` positions) or of the
    pool's blocks (paged: the pool rounded up to the data size, over it,
    and the kv heads over ``model`` where they divide)."""
    ranks, ref, _ = spawned
    cfg = _cfg(variant)
    runs = [r[(variant, layout, shape)] for r in _ranks_of(ranks, shape)]
    data, model = shape
    e = _econ(variant, layout)
    itemsize, lead, rec = 4, cfg.n_layers, 0
    if cfg.family == "hybrid":
        # k/v as the lm family's (a leading axis of shared-block
        # invocations), ssm and conv the rank's lanes, whole over model
        from repro_torch.models import ssm, zamba

        lead = zamba.n_shared_invocations(cfg)
        _, H, conv_ch = ssm.mamba_dims(cfg)
        lanes = runs[0]["cache_shapes"]["k"][1]
        assert runs[0]["cache_shapes"]["ssm"] == (cfg.n_layers, lanes, H, cfg.ssm.state,
                                                  cfg.ssm.head_dim)
        assert runs[0]["cache_shapes"]["conv"] == (cfg.n_layers, lanes,
                                                   cfg.ssm.conv_kernel - 1, conv_ch)
        rec = sum(np.prod(runs[0]["cache_shapes"][n]) for n in ("ssm", "conv")) * itemsize
    if layout == "slotted":
        slots = e["max_slots"]
        if slots % data:
            local = (slots, e["max_len"] // (data * model))
        else:
            local = (slots // data, e["max_len"] // model)
        assert runs[0]["cache_shapes"]["k"][-4:] == local + (cfg.n_kv, cfg.head_dim)
    else:
        heads = cfg.n_kv // model if cfg.n_kv % model == 0 else cfg.n_kv
        want_nb = e.get("num_blocks") or 4 * 4 + 1
        nb = -(-want_nb // data) * data           # the pool rounded up to the data size
        assert runs[0]["cache_shapes"]["k"][-4:] == (nb // data, 8, heads, cfg.head_dim)
    for r in runs:
        assert r["kv_bytes"] == 2 * lead * np.prod(r["cache_shapes"]["k"][-4:]) * itemsize + rec
    want = ref["kv_bytes_per_device"][(variant, layout, shape)]
    assert runs[0]["kv_bytes"] == want
    if _ref_shape(variant, shape) == shape:     # the reference's engine itself
        assert want == ref[(variant, layout, shape)]["kv_bytes_per_device"]


def test_decode_attention_sequence_sharded_matches_reference(spawned):
    """At 2 ranks against the reference's ``decode_attention`` under
    ``DecodeSharding`` ((data), (model)) on a (1, 2) mesh: the output on
    both ranks, each rank's half of the written cache, two all-reduces."""
    ranks, ref, _ = spawned
    assert ref["decode_sharding"] == (("data",), ("model",))
    for i in range(N_DEC):
        want = ref["decode_attention"][i]
        for r, res in enumerate(ranks[2]):
            got = res["decode_attention"][i]
            np.testing.assert_allclose(got["o"].numpy(), want["o"], rtol=1e-5, atol=1e-6)
            for n in ("kc", "vc"):
                np.testing.assert_array_equal(got[n].numpy(), want[n][:, r * 8:(r + 1) * 8])
            assert got["combine"] == 2


# ---------------------------------------------------------------------------
# In this process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gloo1():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    group = init_group("gloo", 0, 1, f"tcp://127.0.0.1:{_free_port()}", device="cpu",
                       timeout_s=60)
    yield group
    group.close()
    torch.set_num_threads(torch_threads)


ONE_BY_ONE = [(a, lay) for a in ARCHS for lay in LAYOUTS] + [(ZAMBA, "slotted")]


@pytest.mark.parametrize("arch,layout", ONE_BY_ONE, ids=[f"{a}-{lay}" for a, lay in ONE_BY_ONE])
def test_one_by_one_mesh_equals_no_mesh_bitwise(gloo1, arch, layout):
    """(1, 1) over a one-rank gloo group (every collective runs) against
    ``mesh=None``, bf16 as served: streams, the host-sampled logits of
    every step, the cache's bytes and the counters, bitwise; the
    collectives of a decode step by formula."""
    mesh = mesh_from_group(gloo1, (1, 1))
    cfg = dataclasses.replace(get_smoke_config(arch), attn_impl="kernel")
    init = registry_init(cfg)
    out = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        row = {}
        for fused in (True, False):
            eng = ServeEngine(cfg, init, EngineConfig(**_econ(arch, layout, fused)),
                              device="cpu", mesh=m)
            seen = _recording(eng)
            row[fused] = (_serve(arch, layout, eng), seen, eng.kv_reserved_bytes,
                          {k: v for k, v in eng.stats.items() if k != "mesh"})
        out[name] = row
    for fused in (True, False):
        a, b = out["plain"][fused], out["mesh"][fused]
        assert a[0] == b[0] and a[2] == b[2] and a[3] == b[3]
        assert len(a[1]) == len(b[1])
        for (x, _), (y, _) in zip(a[1], b[1]):
            assert np.array_equal(x, y)
    # one eager decode step's collectives
    eng = ServeEngine(cfg, init, EngineConfig(**_econ(arch, layout)), device="cpu", mesh=mesh)
    eng.submit(_prompts(arch, cfg.vocab)[0], max_new_tokens=4)
    eng.step()
    common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
    eng.decode_program(stochastic=False, masked=False)(eng.params, eng.state)
    # a layer's seven sharded weights and the embedding read twice (or
    # the embedding and the unembedding); the embedding's and every
    # layer's two row-parallel sums; the slotted layout's q, k, v gathers
    # and LSE combine over the model axis, and its lanes' logits gathered
    # over the data axis; the paged layout's merge of the data ranks'
    # partials a layer; the logits' gather over the model axis
    L = cfg.n_layers
    slotted = layout == "slotted"
    if cfg.family == "hybrid":
        # the shared block's eight sharded weights each invocation, each
        # Mamba2 block's in_proj and out_proj, the embedding and the
        # unembedding, gathered over data; the embedding's, the shared
        # block's two and each Mamba2 block's row-parallel sums; the
        # shared block's every-head q, k, v gathers and LSE combine, each
        # Mamba2 block's projection and conv weights gathered over model;
        # the logits over model and the lanes' over data
        from repro_torch.models import zamba

        sh = zamba.n_shared_invocations(cfg)
        assert common.COUNTS == {**dict.fromkeys(common.COUNTS, 0),
                                 "all_gather": 8 * sh + 2 * L + 2,
                                 "reduce_from_model": 2 * sh + L + 1,
                                 "model_all_gather": 3 * sh + 3 * L + 1,
                                 "decode_combine": 2 * sh, "data_all_gather": 1}
        return
    assert common.COUNTS == {**dict.fromkeys(common.COUNTS, 0),
                             "all_gather": 7 * L + 2,
                             "reduce_from_model": 2 * L + 1,
                             "model_all_gather": (3 * L if slotted else 0) + 1,
                             "decode_combine": 2 * L if slotted else 0,
                             "data_all_gather": 1 if slotted else 0,
                             "data_combine": 0 if slotted else 2 * L}


def _fake_mesh(shape):
    """A mesh's coordinates without process groups (rank 0)."""
    cpu = torch.device("cpu")
    groups = {a: DataGroup(None, 0, n, cpu) for a, n in zip(("data", "model"), shape)}
    groups["dp"] = groups["data"]
    return MeshGroup(("data", "model"), tuple(shape), (0, 0), 0, cpu, None, groups)


def test_cache_layouts_local_shapes():
    """This rank's cache leaves: ``max_slots / data`` lanes of ``max_len /
    M`` positions of every kv head (slotted), or under the batch fallback
    every lane with ``max_len / world`` positions; the pool's blocks over
    the data axis and its kv heads over ``model`` where they divide, else
    every one (paged); what does not divide is refused."""
    live = _fake_mesh((2, 4))
    g = get_smoke_config("gemma2-27b")                  # 2 kv heads, 4 layers as (2, 2)
    k = lm.make_cache_specs(g, 4, 32, mesh=live)["k"]
    assert tuple(k.shape) == (2, 2, 2, 8, 2, 16)
    dec = tattn.DecodeSharding.choose(live, 4)
    assert lm.cache_pspec(g, dec)["k"] == (None, None, ("data",), ("model",), None, None)
    assert dec.local_lanes(4) == (0, 2) and dec.local_len(32) == 8
    # the batch fallback: 3 lanes do not divide over 2 data ranks
    k3 = lm.make_cache_specs(g, 3, 32, mesh=live)["k"]
    assert tuple(k3.shape) == (2, 2, 3, 4, 2, 16)
    fb = tattn.DecodeSharding.choose(live, 3)
    assert lm.cache_pspec(g, fb)["k"] == (None, None, None, ("data", "model"), None, None)
    assert fb.local_lanes(3) == (0, 3) and fb.seq_ranks == 8
    two = _fake_mesh((1, 2))
    assert tuple(lm.make_paged_cache_specs(g, 9, 8, mesh=two)["k"].shape) == (2, 2, 9, 8, 1, 16)
    assert tuple(lm.make_paged_cache_specs(g, 10, 8, mesh=live)["k"].shape) == (2, 2, 5, 8, 2, 16)
    assert lm.paged_cache_pspec(g, live)["k"] == (None, None, ("data",), None, None, None)
    assert lm.paged_cache_pspec(g, two)["k"] == (None, None, ("data",), None, ("model",), None)
    with pytest.raises(ValueError, match="max_len 30 does not divide over 4 ranks"):
        lm.make_cache_specs(g, 4, 30, mesh=live)
    with pytest.raises(ValueError, match="9 does not divide over 2 ranks"):
        lm.make_paged_cache_specs(g, 9, 8, mesh=live)
    # the reference's choice: lanes over data where they divide, else the
    # positions over every axis
    assert tattn.DecodeSharding.choose(live, 4).batch_axes == ("data",)
    assert tattn.DecodeSharding.choose(live, 1).seq_axes == ("data", "model")


def test_zamba_cache_layout_local_shapes():
    """zamba2's leaves a rank holds, the reference's ``cache_pspec``: at
    (2, 2) and 4 lanes of 32 positions, ``k``/``v`` 2 lanes of 16
    positions, ``ssm`` and ``conv`` 2 lanes whole; under the batch
    fallback (3 lanes) every lane, ``k``/``v`` 8 positions and the
    recurrent leaves whole."""
    from repro_torch.models import zamba

    live = _fake_mesh((2, 2))
    z = get_smoke_config(ZAMBA)
    shapes = lambda b: {n: tuple(t.shape)
                        for n, t in zamba.make_cache_specs(z, b, 32, mesh=live).items()}
    assert shapes(4) == {"k": (3, 2, 16, 4, 16), "v": (3, 2, 16, 4, 16),
                         "ssm": (5, 2, 8, 16, 16), "conv": (5, 2, 3, 160)}
    assert shapes(3) == {"k": (3, 3, 8, 4, 16), "v": (3, 3, 8, 4, 16),
                         "ssm": (5, 3, 8, 16, 16), "conv": (5, 3, 3, 160)}
    dec = tattn.DecodeSharding.choose(live, 4)
    assert zamba.cache_pspec(z, dec) == {
        "k": (None, ("data",), ("model",), None, None), "v": (None, ("data",), ("model",),
                                                              None, None),
        "ssm": (None, ("data",), None, None, None), "conv": (None, ("data",), None, None)}
    assert zamba.make_cache_specs(z, 4, 32)["ssm"].dtype == torch.float32
    with pytest.raises(ValueError, match="max_len 31 does not divide over 2 ranks"):
        zamba.make_cache_specs(z, 4, 31, mesh=live)


def test_mesh_refusals(gloo1):
    """What a mesh does not serve raises, naming its ROADMAP item: the
    slot-served families other than the ``lm`` and hybrid families at a
    live model axis, as a target or as a speculation draft.  zamba2 runs
    there, as a target and as a draft (its multi-rank runs are this
    file's and ``test_torch_serve_mesh_features.py``'s spawns)."""
    live = _fake_mesh((1, 2))
    ec = EngineConfig(max_slots=2, max_len=32)
    zamba = get_smoke_config("zamba2-1.2b")
    xlstm = get_smoke_config("xlstm-1.3b")
    for arch in ("zamba2-1.2b", "xlstm-1.3b"):
        cfg = get_smoke_config(arch)
        if arch == "zamba2-1.2b":
            # past the family's check: the fake mesh has no process group
            with pytest.raises(ValueError, match="needs a process group"):
                ServeEngine(cfg, None, ec, device="cpu", mesh=live)
            continue
        with pytest.raises(NotImplementedError, match="the model axis for the other families"):
            ServeEngine(cfg, None, ec, device="cpu", mesh=live)
    from repro_torch.serve import generate_static
    with pytest.raises(NotImplementedError, match="the model axis for the other families"):
        generate_static(get_smoke_config("whisper-tiny"), None, np.zeros((1, 4), np.int32),
                        mesh=live)
    cfg = get_smoke_config("smollm-360m")
    with pytest.raises(ValueError, match="needs a process group"):
        ServeEngine(cfg, None, dataclasses.replace(ec, spec_draft=zamba, spec_k=2),
                    device="cpu", mesh=live)
    with pytest.raises(NotImplementedError, match="xlstm-1.3b-smoke: serving on a live model axis"):
        ServeEngine(cfg, None, dataclasses.replace(ec, spec_draft=xlstm, spec_k=2),
                    device="cpu", mesh=live)
    # zamba at a model axis of 1 runs the serving mesh program (its
    # weights' shards; collectives over one-rank groups)
    one = mesh_from_group(gloo1, (1, 1))
    z = ServeEngine(zamba, registry_init(zamba), ec, device="cpu", mesh=one)
    assert z.shards is not None and z.mesh is one


# the engine's features on a (1, 1) mesh: (arch, scenario of
# test_torch_serve_mesh_features.py, layout)
FEATURES = [("smollm-360m", "spec", "slotted"), ("smollm-360m", "spec", "paged"),
            ("smollm-360m", "tier", "slotted"), ("smollm-360m", "tier", "paged"),
            ("zamba2-1.2b", "tier", "slotted"), ("smollm-360m", "spectier", "paged"),
            ("smollm-360m", "snapshot", "slotted"), ("smollm-360m", "snapshot", "paged"),
            ("smollm-360m", "migration", "paged"), ("zamba2-1.2b", "spec", "slotted"),
            ("zamba2-1.2b", "snapshot", "slotted"), ("zamba2-1.2b", "migration", "slotted")]


@pytest.mark.parametrize("arch,name,layout", FEATURES,
                         ids=[f"{a}-{n}-{lay}" for a, n, lay in FEATURES])
def test_one_by_one_mesh_features_equal_no_mesh_bitwise(gloo1, tmp_path, arch, name, layout):
    """Speculation, the host tier with hold, park and release, snapshots
    (``snapshot``/``restore`` and ``save_snapshot``/``restore_snapshot``)
    and migration on ``(1, 1)`` over a one-rank gloo group (every
    collective runs) against ``mesh=None``, bf16 as served: streams,
    counters and every engine's ``stats`` bitwise.  zamba2's too (its
    tier, speculation with zamba2 as target and draft, snapshots and
    migration, slotted), under the serving mesh program."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.serve import HostTier
    from test_torch_serve_mesh_features import SPEC_LAYOUTS, FakeClock, _port_make, scenario

    mesh = mesh_from_group(gloo1, (1, 1))
    cfg = dataclasses.replace(get_smoke_config(arch), attn_impl="kernel")
    init, draft = registry_init(cfg), registry_init(cfg, seed=1)
    out = {}
    for m in (None, mesh):
        made = []
        make = _port_make(cfg, init, draft, m)

        def recording(clock, **kw):
            made.append(make(clock, **kw))
            return made[-1]

        def save(eng, step):
            mgr = CheckpointManager(str(tmp_path / f"snap_{m is None}"))
            eng.save_snapshot(mgr, step)
            fresh = recording(FakeClock(), **SPEC_LAYOUTS[layout])
            assert fresh.restore_snapshot(mgr) == step
            return fresh

        res = scenario(name, layout, recording, cfg.vocab, save=save, tier=HostTier)
        res.pop("shares", None)
        out[m is None] = (res, [{k: v for k, v in e.stats.items() if k != "mesh"}
                                for e in made])
    assert out[True] == out[False]
    # the feature ran: what it counts, on the first engine (or the restored one)
    stats = out[False][1]
    key = {"spec": "spec_steps", "tier": "restores", "spectier": "restores",
           "snapshot": "snapshot_restores", "migration": "exported"}[name]
    assert stats[name == "snapshot"][key] > 0, stats


def registry_init(cfg, seed=0):
    from repro_torch.models import registry

    return registry.get_module(cfg).init(cfg, seed=seed, device="cpu")


def test_launcher_mesh_choices(capsys, monkeypatch):
    """``--mesh single`` is the one-device engine (its streams and its
    summary's words), ``production`` needs 256 ranks."""
    from repro_torch.launch import serve as launch

    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    argv = ["--arch", "gemma2-27b", "--smoke", "--device", "cpu", "--requests", "4",
            "--kv-layout", "paged"]
    single = launch.main(argv + ["--mesh", "single"])
    out = capsys.readouterr().out
    plain = launch.main(argv)
    assert "status: ok 4" in out and "of mesh" not in out
    assert {r: c.tokens for r, c in single.completions.items()} == \
        {r: c.tokens for r, c in plain.completions.items()}
    with pytest.raises(ValueError, match="needs 256 ranks"):
        launch.main(argv + ["--mesh", "production"])
