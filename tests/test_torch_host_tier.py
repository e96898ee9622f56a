"""The port's host-RAM tier against the JAX reference.

At smoke width in fp32 on the CPU:

* ``HostTier``/``LaneSpill``/``check_tiered`` driven by the same operation
  sequences as the reference's classes return the same values and keep the
  same counters, ``spilled_blocks``, ``host_free`` and ``used_bytes``;
* the four transport programs round-trip bitwise on the port's state, and
  their payloads have the reference programs' shapes, dtypes and bytes;
* the reference's engine properties (``tests/test_host_tier.py``) hold in
  the port, with the hybrid family (zamba) where the reference uses xLSTM:
  an O(copy) resume replays nothing, park is O(copy), a KV hold keeps its
  device state, a recurrent hold spills at once (and raises without a
  tier), spilled prefix chains are promoted back, and the KV gauge is
  exact at a prime block count;
* a fixed schedule of preempt, hold, park and release on each of the four
  layouts: the port's greedy streams equal its untiered slotted engine's
  and the reference's, and the tier counters equal the reference tiered
  engine's under the same schedule.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.aot import AotCache as JAotCache
from repro.models import registry as jreg
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import HostTier as JHostTier
from repro.serve import LaneSpill as JLaneSpill
from repro.serve import ServeEngine as JServeEngine
from repro.serve import step as jstep
from repro.serve.paged import BlockAllocator as JBlockAllocator
from repro.serve.paged import check_tiered as jcheck_tiered
from repro_torch.configs import get_smoke_config
from repro_torch.core.aot import AotCache
from repro_torch.models import registry
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (
    BlockAllocator,
    EngineConfig,
    HostTier,
    LaneSpill,
    ServeEngine,
    check_tiered,
    lane_read_program,
    lane_write_program,
    make_paged_state,
    make_slot_state,
    paged_block_read_program,
    paged_block_write_program,
)

MAX_SLOTS, MAX_LEN, BS = 3, 48, 8

# the reference's four tier layouts (tests/test_host_tier.py), zamba for
# its xLSTM row
LAYOUTS = {
    "slotted": dict(host_tier=True),
    "paged": dict(kv_layout="paged", page_size=BS, num_blocks=6, admission="preempt",
                  host_tier=True),
    "bounded_prefix": dict(kv_layout="paged", page_size=BS, num_blocks=6,
                           prefix_cache=True, admission="preempt", host_tier=True,
                           host_tier_blocks=8),
    "recurrent": dict(host_tier=True, park_idle_s=4.0),
}
ARCH = {"slotted": "smollm-360m", "paged": "smollm-360m",
        "bounded_prefix": "smollm-360m", "recurrent": "zamba2-1.2b"}
TIER_COUNTERS = ("spills", "restores", "spill_drops", "prefix_spills", "host_prefix_hits",
                 "holds", "releases", "parked", "preemptions", "resumed", "replayed_tokens",
                 "prefills", "decode_steps", "spilled_bytes", "restored_bytes",
                 "prefix_hit_tokens")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def archs():
    """fp32 smoke configs and parameters of both packages, per arch, with
    one reference program cache each."""
    out = {}
    for arch in sorted(set(ARCH.values())):
        jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
        tcfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
        jp = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0))
        tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
        out[arch] = (jcfg, jp, tcfg, tp, JAotCache(f"tier-{arch}"))
    return out


def port_engine(archs, arch, aot=None, clock=None, **fields):
    _, _, tcfg, tp, _ = archs[arch]
    return ServeEngine(tcfg, tp, EngineConfig(max_slots=fields.pop("max_slots", MAX_SLOTS),
                                              max_len=MAX_LEN, **fields),
                       device="cpu", aot=aot, clock=clock or FakeClock())


def ref_engine(archs, arch, mesh, rules, clock=None, **fields):
    jcfg, jp, _, _, jaot = archs[arch]
    return JServeEngine(jcfg, mesh, rules, jp, JEngineConfig(
        max_slots=fields.pop("max_slots", MAX_SLOTS), max_len=MAX_LEN, **fields),
        aot=jaot, clock=clock or FakeClock())


def drive(eng, stream, hook=None, *, clock_step=1.0):
    """Replay (tick, prompt, budget) arrivals through one engine (either
    package's); ``hook(eng, tick)`` runs before each step; invariants
    (check_tiered included) after every step."""
    i = tick = 0
    while i < len(stream) or eng.has_work():
        while i < len(stream) and stream[i][0] <= tick:
            _, prompt, budget = stream[i]
            eng.submit(prompt, max_new_tokens=budget, rid=i)
            i += 1
        if hook is not None:
            hook(eng, tick)
        eng.step()
        eng.check_invariants()
        eng.clock.t += clock_step
        tick += 1
        assert tick < 500, "engine failed to drain"
    return [list(eng.completions[r].tokens) for r in range(len(stream))]


# ---------------------------------------------------------------------------
# HostTier / LaneSpill / check_tiered against the reference's classes
# ---------------------------------------------------------------------------


def _ops_bounded_budget_and_lru(Tier, Spill, pay, lane_leaf):
    """The cases of the reference's test_tier_bounded_budget_and_lru."""
    tier = Tier(capacity_blocks=3)
    out = [tier.put_block(b"a", pay()), tier.put_block(b"b", pay()),
           tier.put_block(b"c", pay()), tier.host_free]
    # a fourth block LRU-drops the oldest, never a lane spill
    out += [tier.put_block(b"d", pay()), tier.has_block(b"a"), tier.has_block(b"d"),
            tier.drops]
    # lane spills pin their units: 3 blocks evict every prefix block, 4 do
    # not fit and are refused
    out += [tier.put_lane(Spill(1, "paged", 4, 1, blocks=[pay() for _ in range(3)])),
            tier.spilled_blocks, len(tier._prefix),
            tier.put_lane(Spill(2, "paged", 4, 1, blocks=[pay() for _ in range(4)])),
            tier.has_lane(2)]
    # whole-lane spills are outside the block budget
    out += [tier.put_lane(Spill(3, "lane", 4, 1, leaves={"h": lane_leaf()})),
            tier.spilled_blocks, tier.host_free]
    return tier, out


def _ops_match_chain_and_move(Tier, Spill, pay, lane_leaf):
    """The cases of the reference's test_tier_match_chain_and_move_semantics."""
    tier = Tier()
    out = [tier.put_block(k, pay()) for k in (b"k0", b"k1", b"k2")]
    out += [tier.match_chain([b"k0", b"k1", b"k2", b"k3"]),
            tier.match_chain([b"k0", b"k1", b"k2"], start=1),
            tier.match_chain([b"kX", b"k1"])]
    # pop moves the key out (the device owns it now)
    out += [tier.pop_block(b"k1") is not None, tier.has_block(b"k1"),
            tier.match_chain([b"k0", b"k1"]), tier.pop_block(b"k1") is None]
    # discard drops without counting a hit (republished on the device)
    tier.discard_block(b"k2")
    out += [tier.has_block(b"k2"), tier.put_block(b"k0", pay()), tier.host_free]
    return tier, out


def _ops_stale_lane_replaced(Tier, Spill, pay, lane_leaf):
    """The cases of the reference's test_tier_stale_lane_replaced, plus a
    drop and a lane restore's accounting."""
    tier = Tier()
    out = [tier.put_lane(Spill(7, "paged", 4, 2, blocks=[pay()])),
           tier.put_lane(Spill(7, "paged", 4, 5, blocks=[pay(), pay()])), tier.used_bytes]
    sp = tier.pop_lane(7)
    out += [sp.generated, len(sp.blocks), sp.nbytes, tier.pop_lane(7) is None]
    out += [tier.put_lane(Spill(8, "lane", 6, 3, leaves={"h": lane_leaf(), "c": pay()["k"]})),
            tier.peek_lane(8).nbytes, tier.spilled_lanes]
    tier.drop_lane(8)
    out += [tier.has_lane(8), tier.spilled_lanes]
    return tier, out


TIER_SCRIPTS = {"bounded_budget_and_lru": _ops_bounded_budget_and_lru,
                "match_chain_and_move": _ops_match_chain_and_move,
                "stale_lane_replaced": _ops_stale_lane_replaced}
TIER_STATS = ("lane_spills", "lane_restores", "prefix_spills", "prefix_hits", "drops",
              "spilled_bytes", "restored_bytes", "spilled_blocks", "spilled_lanes",
              "host_free", "used_bytes")


@pytest.mark.parametrize("script", sorted(TIER_SCRIPTS))
def test_tier_ops_match_reference(script):
    """The same operation sequence through the reference's tier (numpy
    payloads) and the port's (host tensors): every return value and every
    counter equal, both tiers' invariants hold."""
    ops = TIER_SCRIPTS[script]
    jt, jout = ops(JHostTier, JLaneSpill, lambda: {"k": np.ones((2, BS), np.float32)},
                   lambda: np.zeros(4, np.float32))
    tt, tout = ops(HostTier, LaneSpill, lambda: {"k": torch.ones(2, BS)},
                   lambda: torch.zeros(4))
    assert tout == jout
    assert {k: getattr(tt, k) for k in TIER_STATS} == {k: getattr(jt, k) for k in TIER_STATS}
    jt.check()
    tt.check()


def test_tier_payload_views_and_numpy():
    """Payloads may be rows of one host buffer (a lane's gathered blocks)
    or numpy views of host tensors: each counts its own bytes."""
    buf = torch.zeros(4, 2, BS)
    sp = LaneSpill(1, "paged", 4, 1, blocks=[{"k": buf[j]} for j in range(4)])
    assert sp.nbytes == buf.nbytes
    tier = HostTier(capacity_blocks=6)
    assert tier.put_lane(sp)
    assert tier.put_block(b"x", {"k": buf[0].numpy()})
    assert tier.used_bytes == buf.nbytes + buf[0].nbytes
    tier.check()
    assert tier.pop_block(b"x")["k"].shape == (2, BS)
    assert tier.used_bytes == buf.nbytes and tier.host_free == 2


def test_check_tiered_matches_reference():
    """Four-state conservation with the tier attached, and the one-owner
    rule: a chain key indexed on the device and resident in the tier
    breaks both packages' sweeps."""
    results = []
    for Alloc, Tier, check, pay in (
            (JBlockAllocator, JHostTier, jcheck_tiered, lambda: {"k": np.ones(4, np.float32)}),
            (BlockAllocator, HostTier, check_tiered, lambda: {"k": torch.ones(4)})):
        alloc, tier = Alloc(6, BS), Tier(capacity_blocks=4)
        spilled = []
        alloc.on_evict = lambda b, key: spilled.append(key) or tier.put_block(key, pay())
        blocks = [alloc.alloc() for _ in range(5)]
        for j, b in enumerate(blocks):
            alloc.publish(b, bytes([j]))
        for b in blocks[:3]:
            alloc.free(b)                       # cached, reclaimable
        check(alloc, tier)
        got = [alloc.alloc(), alloc.alloc()]    # reclaims two LRU cached blocks
        check(alloc, tier)
        results.append((got, spilled, tier.spilled_blocks, tier.host_free,
                        alloc.num_cached, alloc.cache_evictions))
        tier.put_block(bytes([4]), pay())       # key 4 is still device-indexed
        with pytest.raises(AssertionError, match="owned by device index AND host tier"):
            check(alloc, tier)
    assert results[0] == results[1]
    assert results[1][1] == [bytes([0]), bytes([1])]


# ---------------------------------------------------------------------------
# The transport programs
# ---------------------------------------------------------------------------


def _random_cache(state, seed):
    g = torch.Generator().manual_seed(seed)
    for c in state["cache"].values():
        c.copy_(torch.randn(c.shape, generator=g).to(c.dtype))


@pytest.mark.parametrize("kind", ["paged", "lane-dense", "lane-hybrid"])
def test_transport_roundtrip_bitwise(archs, mesh, rules, kind):
    """Read blocks or a lane to host memory and write them back elsewhere:
    the destination equals the source bitwise, nothing else moves, the
    state's tensors are never rebound, and each payload has the reference
    program's shape, dtype and bytes."""
    import jax.numpy as jnp

    arch = "zamba2-1.2b" if kind == "lane-hybrid" else "smollm-360m"
    jcfg, _, tcfg, _, _ = archs[arch]
    if kind == "paged":
        state = make_paged_state(tcfg, MAX_SLOTS, MAX_LEN, 9, BS, "cpu")
        read, write = paged_block_read_program(tcfg), paged_block_write_program(tcfg)
        jread = jstep.paged_block_read_program(jcfg, mesh, rules)
    else:
        axes = registry.lane_leaf_axes(tcfg)
        state = make_slot_state(tcfg, MAX_SLOTS, MAX_LEN, "cpu")
        read, write = lane_read_program(tcfg, axes=axes), lane_write_program(tcfg, axes=axes)
        jread = jstep.lane_read_program(jcfg, mesh, rules, axes=jreg.lane_leaf_axes(jcfg))
    _random_cache(state, 0)
    before = {k: v.clone() for k, v in state["cache"].items()}
    ptrs = {k: v.data_ptr() for k, v in state["cache"].items()}
    jstate = {"cache": {k: jnp.asarray(v.numpy()) for k, v in before.items()}}
    if kind == "paged":
        src, dst = [5, 2, 7], [1, 8, 3]
        payloads = read(state, src)
        assert len(payloads) == 3
        want = [jread(jstate, b) for b in src]
        write(state, payloads, dst)
        for k, c in state["cache"].items():
            assert torch.equal(c[:, dst], before[k][:, src])
            keep = [b for b in range(9) if b not in dst]
            assert torch.equal(c[:, keep], before[k][:, keep])
        # payloads rebuilt one by one (not rows of one buffer) write the same
        write(state, [{k: v.clone() for k, v in p.items()} for p in payloads], [4, 6, 0])
        assert all(torch.equal(c[:, [4, 6, 0]], before[k][:, src])
                   for k, c in state["cache"].items())
    else:
        payloads = [read(state, 2)]
        want = [jread(jstate, 2)]
        write(state, payloads[0], 0)
        for k, c in state["cache"].items():
            ax = axes[k]
            assert torch.equal(c.select(ax, 0), before[k].select(ax, 2))
            for lane in (1, 2):
                assert torch.equal(c.select(ax, lane), before[k].select(ax, lane))
    assert {k: v.data_ptr() for k, v in state["cache"].items()} == ptrs
    for got, ref in zip(payloads, want):
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert tuple(got[k].shape) == tuple(ref[k].shape)
            assert str(got[k].dtype).split(".")[-1] == str(ref[k].dtype)
            assert got[k].nbytes == np.asarray(ref[k]).nbytes
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


# ---------------------------------------------------------------------------
# Engine properties (the reference's tests/test_host_tier.py)
# ---------------------------------------------------------------------------


def _want(archs, arch, stream):
    """The port's untiered slotted engine's greedy streams."""
    return drive(port_engine(archs, arch), stream)


def test_preempted_lane_restores_without_replay(archs):
    stream = [(0, np.arange(1, 13, dtype=np.int32), 8)]
    eng = port_engine(archs, "smollm-360m", **LAYOUTS["paged"])

    def hook(eng, tick):
        if tick == 3 and eng.slots[0] is not None and eng.slots[0].generated >= 2:
            eng.preempt(0)

    assert drive(eng, stream, hook) == _want(archs, "smollm-360m", stream)
    c = eng.counters
    assert c["preemptions"] == 1 and c["spills"] == 1 and c["restores"] == 1
    assert c["replayed_tokens"] == 0 and c["prefills"] == 1
    assert c["restored_bytes"] == c["spilled_bytes"] > 0
    assert eng.tier.spilled_lanes == 0 and eng.tier.used_bytes == 0


def test_park_is_o_copy_not_replay(archs):
    stream = [(0, np.arange(1, 13, dtype=np.int32), 8)]
    eng = port_engine(archs, "smollm-360m", **{**LAYOUTS["paged"], "park_idle_s": 4.0})
    seen = {"parked": False}

    def hook(eng, tick):
        if tick == 2:
            assert eng.hold(0)
            eng.clock.t += 10.0                 # idle past the threshold
        if eng.parked and not seen["parked"]:
            seen["parked"] = True
            assert all(s is None for s in eng.slots)    # the lane was freed
            eng.release(0)

    assert drive(eng, stream, hook) == _want(archs, "smollm-360m", stream)
    c = eng.counters
    assert seen["parked"] and c["parked"] == 1 and c["spills"] >= 1 and c["restores"] >= 1
    assert c["replayed_tokens"] == 0 and c["preemptions"] == 0


def test_hold_release_kv_keeps_device_state(archs):
    stream = [(0, np.arange(1, 10, dtype=np.int32), 6)]
    eng = port_engine(archs, "smollm-360m", **LAYOUTS["slotted"])

    def hook(eng, tick):
        if tick == 2:
            eng.hold(0)
        if tick == 5:
            eng.release(0)

    assert drive(eng, stream, hook) == _want(archs, "smollm-360m", stream)
    c = eng.counters
    assert c["holds"] == 1 == c["releases"] and c["restores"] == 0 == c["replayed_tokens"]


def test_hold_recurrent_spills_immediately(archs):
    stream = [(0, np.arange(1, 10, dtype=np.int32), 6), (1, np.arange(3, 14, dtype=np.int32), 5)]
    eng = port_engine(archs, "zamba2-1.2b", **LAYOUTS["recurrent"])

    def hook(eng, tick):
        if tick == 2 and eng.slots[0] is not None:
            eng.hold(eng.slots[0].rid)
            assert eng.counters["spills"] == 1
        if tick == 4 and eng.slots[0] is not None and eng.slots[0].held:
            eng.release(eng.slots[0].rid)

    assert drive(eng, stream, hook) == _want(archs, "zamba2-1.2b", stream)
    assert eng.counters["restores"] >= 1 and eng.counters["replayed_tokens"] == 0


def test_hold_recurrent_without_tier_raises(archs):
    eng = port_engine(archs, "zamba2-1.2b")
    eng.submit(np.arange(1, 8, dtype=np.int32), max_new_tokens=4)
    eng.step()
    with pytest.raises(ValueError, match="host tier"):
        eng.hold(0)
    eng.drain()


def test_host_tier_second_level_prefix_cache(archs, mesh, rules):
    """A cached chain the pool reclaims spills to the tier and a later
    admission promotes it back: the stream is the first run's, and the
    reference's tiered engine, driven through the same requests, gives the
    same streams and tier counters."""
    _, _, tcfg, _, _ = archs["smollm-360m"]
    fields = dict(max_slots=2, kv_layout="paged", page_size=BS, num_blocks=8,
                  prefix_cache=True, host_tier=True)
    eng = port_engine(archs, "smollm-360m", **fields)
    sys_prompt = np.arange(1, 17, dtype=np.int32)           # 2 full blocks

    def run(eng, prompt, rid):
        eng.submit(prompt, max_new_tokens=4, rid=rid)
        while eng.has_work():
            eng.step()
            eng.check_invariants()
        return list(eng.completions[rid].tokens)

    prompts = [sys_prompt]
    first = run(eng, sys_prompt, 0)
    assert eng.alloc.num_cached > 0
    rng = np.random.default_rng(7)
    while eng.counters["prefix_spills"] == 0:
        prompts.append(rng.integers(100, tcfg.vocab, 24).astype(np.int32))
        run(eng, prompts[-1], len(prompts) - 1)
        assert len(prompts) < 20, "pool churn never evicted the cached chain"
    assert eng.tier.spilled_blocks > 0
    hits0 = eng.counters["prefix_hit_tokens"]
    prompts.append(sys_prompt)
    assert run(eng, sys_prompt, len(prompts) - 1) == first
    assert eng.counters["host_prefix_hits"] > 0
    assert eng.counters["prefix_hit_tokens"] > hits0

    ref = ref_engine(archs, "smollm-360m", mesh, rules, **fields)
    assert [run(ref, p, rid) for rid, p in enumerate(prompts)] == \
        [list(eng.completions[rid].tokens) for rid in range(len(prompts))]
    assert {k: eng.counters[k] for k in TIER_COUNTERS} == \
        {k: ref.counters[k] for k in TIER_COUNTERS}


def test_kv_gauge_exact_with_prime_block_count(archs):
    eng = port_engine(archs, "smollm-360m", max_slots=2, kv_layout="paged", page_size=BS,
                      num_blocks=7)
    blocks = [eng.alloc.alloc() for _ in range(eng.alloc.num_free)]
    eng._note_kv_usage()
    want = eng.kv_reserved_bytes * eng.alloc.capacity // eng._num_blocks
    assert eng.counters["kv_peak_used_bytes"] == want
    assert eng.kv_reserved_bytes - want <= -(-eng.kv_reserved_bytes // eng._num_blocks)
    for b in blocks:
        eng.alloc.free(b)


def test_tier_config_checks(archs):
    with pytest.raises(ValueError, match="requires host_tier"):
        port_engine(archs, "smollm-360m", host_tier_blocks=4)
    with pytest.raises(ValueError, match="host_tier instance"):
        _, _, tcfg, tp, _ = archs["smollm-360m"]
        ServeEngine(tcfg, tp, EngineConfig(), device="cpu", host_tier=HostTier())
    shared = HostTier(16)
    _, _, tcfg, tp, _ = archs["smollm-360m"]
    a = ServeEngine(tcfg, tp, EngineConfig(max_slots=2, max_len=MAX_LEN, host_tier=True),
                    device="cpu", host_tier=shared)
    assert a.tier is shared and a.stats["host_tier"]["capacity_blocks"] == 16


# ---------------------------------------------------------------------------
# A fixed schedule on every layout, against the reference
# ---------------------------------------------------------------------------

# tick -> ops; each acts on the first decoding lane (preempt: the last),
# release on the first held or parked request, idle moves the clock past
# the park threshold
SCHEDULE = {2: ["preempt"], 3: ["hold"], 4: ["idle"], 5: ["preempt"], 6: ["hold"],
            8: ["release"], 9: ["idle", "hold"], 11: ["release"], 12: ["release"]}


def _stream(vocab, seed=5):
    rng = np.random.default_rng(seed)
    out, tick = [], 0
    for _ in range(5):
        tick += int(rng.integers(0, 3))
        plen, budget = int(rng.integers(2, 20)), int(rng.integers(3, 8))
        out.append((tick, rng.integers(0, vocab, plen).astype(np.int32), budget))
    return out


def _scheduled(eng, tick):
    if tick > max(SCHEDULE):
        for s in list(eng.slots):
            if s is not None and s.held:
                eng.release(s.rid)
        for rid in sorted(eng.parked):
            eng.release(rid)
        return
    for op in SCHEDULE.get(tick, ()):
        decoding = [i for i, s in enumerate(eng.slots) if s is not None
                    and s.prefilled >= s.plen and s.generated >= 1 and not s.held]
        held = [s.rid for s in eng.slots if s is not None and s.held]
        if op == "preempt" and decoding:
            eng.preempt(decoding[-1])
        elif op == "hold" and decoding:
            eng.hold(eng.slots[decoding[0]].rid)
        elif op == "release" and (held or eng.parked):
            eng.release((held + sorted(eng.parked))[0])
        elif op == "idle":
            eng.clock.t += 5.0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_schedule_matches_reference(archs, mesh, rules, layout):
    arch = ARCH[layout]
    stream = _stream(archs[arch][2].vocab)
    eng = port_engine(archs, arch, **LAYOUTS[layout])
    got = drive(eng, stream, _scheduled)
    assert got == _want(archs, arch, stream)
    assert got == drive(ref_engine(archs, arch, mesh, rules), stream)
    ref = ref_engine(archs, arch, mesh, rules, **LAYOUTS[layout])
    drive(ref, stream, _scheduled)
    assert {k: eng.counters[k] for k in TIER_COUNTERS} == \
        {k: ref.counters[k] for k in TIER_COUNTERS}
    assert eng.counters["spills"] > 0 and eng.counters["restores"] > 0
    assert eng.counters["holds"] > 0 and eng.counters["replayed_tokens"] == 0
    assert eng.tier.spilled_lanes == 0
    assert all(c.status == "ok" for c in eng.completions.values())
    if layout == "recurrent":
        assert eng.counters["parked"] > 0


# ---------------------------------------------------------------------------
# chip_smoke.py's tier phases, rehearsed at smoke width
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_run(cs, cfg, params, reqs, ec, tier=None, after_step=None):
    eng = ServeEngine(cfg, params, ec, device="cpu", host_tier=tier)
    rids = [eng.submit(p, max_new_tokens=b) for p, b in reqs]
    while eng.has_work():
        eng.step()
        eng.check_invariants()
        if after_step is not None:
            after_step(eng)
    return eng, [list(eng.completions[r].tokens) for r in rids]


def test_chip_smoke_tier_schedules():
    """chip_smoke.py's phases 3f and 3g at smoke width in fp32: the counters
    the card must show (``TIER_3F``, ``TIER_3G``: the schedule does not
    depend on the values), the requests 3g re-admits on promoted chains
    and where they restart (``TIER_3G_PROMOTED``), every promoted block
    bitwise the payload the tier kept, and the streams: 3f's the untiered
    phase-3 engine's, 3g's the tierless 3b engine's, and the promoted
    requests' also their prefix witness's."""
    from repro_torch.models import lm

    cs = _chip_smoke()
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), compute_dtype="float32")
    params = lm.init(cfg, seed=0, device="cpu")
    bb = 2 * cfg.n_layers * cs.PAGE * cfg.n_kv * cfg.head_dim * 4

    phase3 = cs.requests(cfg.vocab)
    _, want3 = _smoke_run(cs, cfg, params, phase3, EngineConfig(
        max_slots=cs.MAX_SLOTS, max_len=cs.MAX_LEN, kv_layout="paged", page_size=cs.PAGE,
        paged_attn="kernel"))
    tier = cs.logging_tier()
    eng, got = _smoke_run(cs, cfg, params, phase3, cs.feature_engine(
        prefill_chunk=0, prefix_cache=False, host_tier=True), tier)
    assert got == want3
    assert cs.tier_counters(eng, bb) == cs.TIER_3F
    assert sum(tier.lanes_in) == sum(tier.lanes_out) == cs.TIER_3F["spilled_blocks"]

    reqs_b = cs.feature_requests(cfg.vocab)
    _, want_b = _smoke_run(cs, cfg, params, reqs_b, cs.feature_engine())
    tier, checked = cs.logging_tier(cs.TIER_3G_BLOCKS), []
    eng, got = _smoke_run(cs, cfg, params, reqs_b, cs.feature_engine(
        host_tier=True, host_tier_blocks=cs.TIER_3G_BLOCKS), tier,
        cs.promotion_check(torch, tier, checked))
    assert cs.tier_counters(eng, bb) == cs.TIER_3G
    assert len(checked) == cs.TIER_3G["host_prefix_hits"]
    starts = cs.promoted_starts(tier, reqs_b)
    assert starts == cs.TIER_3G_PROMOTED
    assert got == want_b
    witness = cs.prefix_witness(cfg, params, reqs_b, starts, cs.feature_engine(), "cpu")
    assert witness == {i: got[i] for i in starts}
