"""The port's serving stack (``repro_torch.serve``) against the JAX reference.

* Engine parity: the reference's ``ServeEngine`` and the port's, on the
  same converted smoke parameters and prompts, fp32 compute and greedy
  sampling, produce equal token streams on both KV layouts (and with the
  kernel settings, whose wrappers run their plain versions on CPU).
* Inside the port, slotted and paged serving are bitwise equal.
* ``sample_tokens``: the greedy path and the top-k / top-p masks agree
  with the reference on the same logits (the random draws cannot: torch
  and ``jax.random`` give different bits).
* The host-side copies (``prompt_buckets``, ``BlockAllocator``,
  ``SlotTables``) behave as the reference's under the same operations.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import registry as jreg
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import cache as jcache
from repro.serve import paged as jpaged
from repro.serve import step as jstep
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (
    BlockAllocator,
    EngineConfig,
    ServeEngine,
    SlotTables,
    bucket_for,
    prompt_buckets,
)
from repro_torch.serve import step as tstep

LENS = [5, 11, 8, 14, 4, 20]
BUDGETS = [7, 3, 5, 2, 6, 9]


@pytest.fixture(scope="module")
def models():
    """fp32-compute smoke configs and parameters for both packages (fp32 so
    greedy streams agree across frameworks)."""
    jcfg = dataclasses.replace(jax_smoke("smollm-360m"), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("smollm-360m"),
                               compute_dtype="float32")
    jp = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32) for n in LENS]
    return jcfg, jp, tcfg, tp, prompts


def _serve(eng, prompts, budgets=BUDGETS):
    rids = [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    eng.drain()
    return [list(eng.completions[r].tokens) for r in rids]


@pytest.fixture(scope="module")
def jax_streams(models, mesh, rules):
    """Greedy streams of the reference engine, one run per (layout, eos)."""
    jcfg, jp, _, _, prompts = models
    runs = {}

    def get(layout, eos_id=None):
        if (layout, eos_id) not in runs:
            ec = JEngineConfig(max_slots=2, max_len=32, kv_layout=layout,
                               page_size=8, eos_id=eos_id)
            runs[layout, eos_id] = _serve(JServeEngine(jcfg, mesh, rules, jp, ec),
                                          prompts)
        return runs[layout, eos_id]

    return get


@pytest.mark.parametrize("layout,attn_impl,paged_attn", [
    ("slotted", "chunked", "ref"),
    ("slotted", "kernel", "ref"),
    ("paged", "chunked", "ref"),
    ("paged", "kernel", "kernel"),
])
def test_engine_matches_reference(models, jax_streams, layout, attn_impl, paged_attn):
    """Staggered trace (more requests than lanes, lanes reused): the
    port's greedy streams equal the reference engine's."""
    _, _, tcfg, tp, prompts = models
    want = jax_streams(layout)
    eng = ServeEngine(dataclasses.replace(tcfg, attn_impl=attn_impl), tp,
                      EngineConfig(max_slots=2, max_len=32, kv_layout=layout,
                                   page_size=8, paged_attn=paged_attn),
                      device="cpu")
    got = _serve(eng, prompts)
    eng.check_invariants()
    assert got == want
    assert [len(t) for t in got] == BUDGETS
    assert all(c.status == "ok" for c in eng.completions.values())
    assert eng.stats["prefills"] == len(prompts)


def test_eos_eviction_matches_reference(models, jax_streams):
    """An EOS token ends a request early, in both engines alike."""
    _, _, tcfg, tp, prompts = models
    eos = jax_streams("paged")[0][2]
    want = jax_streams("paged", eos_id=eos)
    eng = ServeEngine(tcfg, tp, EngineConfig(max_slots=2, max_len=32,
                                             kv_layout="paged", page_size=8,
                                             eos_id=eos), device="cpu")
    got = _serve(eng, prompts)
    assert got == want and got[0][-1] == eos and len(got[0]) == 3


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_slotted_equals_paged_bitwise(models, compute):
    """Inside the port: the same prompt and decode inputs through the
    slotted and paged paths give bitwise-equal logits, and the two engines
    equal token streams (bf16 included)."""
    _, _, tcfg, tp, prompts = models
    cfg = dataclasses.replace(tcfg, compute_dtype=compute)
    p = tlm.cast_for_compute(cfg, tp)
    toks = torch.tensor(np.pad(prompts[3], (0, 2)))[None]     # bucket 16
    sc = {k: torch.zeros_like(s, device="cpu")
          for k, s in tlm.make_cache_specs(cfg, 2, 32).items()}
    pc = {k: torch.zeros_like(s, device="cpu")
          for k, s in tlm.make_paged_cache_specs(cfg, 9, 8).items()}
    tables = torch.tensor([[0, 0, 0, 0], [5, 2, 7, 0]], dtype=torch.int32)
    sc, ls = tlm.prefill_slot(cfg, p, sc, toks, 1, 14)
    pc, lp = tlm.prefill_slot_paged(cfg, p, pc, toks, tables[1], 14)
    assert torch.equal(ls, lp)
    lengths = torch.tensor([0, 14], dtype=torch.int32)
    for t in range(4):
        tok = torch.tensor([0, t + 1], dtype=torch.int32)
        ls, sc = tlm.decode_step(cfg, p, sc, tok, lengths)
        lp, pc = tlm.decode_step_paged(cfg, p, pc, tok, lengths, tables)
        assert torch.equal(ls[1], lp[1])
        lengths = lengths + torch.tensor([0, 1], dtype=torch.int32)
    streams = [_serve(ServeEngine(cfg, tp, EngineConfig(
        max_slots=2, max_len=32, kv_layout=layout, page_size=8), device="cpu"),
        prompts) for layout in ("slotted", "paged")]
    assert streams[0] == streams[1]


def test_paged_admission_gates_and_conserves(models):
    """A pool smaller than every lane's worst case: deficit admission holds
    requests back, invariants hold after every step, and every block
    returns to the pool once the trace drains."""
    _, _, tcfg, tp, prompts = models
    eng = ServeEngine(tcfg, tp, EngineConfig(max_slots=3, max_len=32,
                                             kv_layout="paged", page_size=8,
                                             num_blocks=7), device="cpu")
    rids = [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, BUDGETS)]
    eng.step()
    assert eng.queue, "the small pool must gate admission"
    while eng.step():
        eng.check_invariants()
    assert sorted(eng.completions) == rids
    assert eng.alloc.in_use == 0 and eng.alloc.num_free == eng.alloc.capacity
    assert eng.stats["kv_peak_used_bytes"] <= eng.kv_reserved_bytes
    tiny = ServeEngine(tcfg, tp, EngineConfig(max_slots=1, max_len=32,
                                              kv_layout="paged", page_size=8,
                                              num_blocks=3), device="cpu")
    with pytest.raises(ValueError, match="KV blocks"):
        tiny.submit(np.zeros(20, np.int32), max_new_tokens=12)


def test_sampled_requests_are_seeded(models):
    _, _, tcfg, tp, prompts = models

    def run(seed):
        eng = ServeEngine(tcfg, tp, EngineConfig(max_slots=2, max_len=32,
                                                 seed=seed), device="cpu")
        rids = [eng.submit(p, max_new_tokens=6, temperature=0.9, top_k=20,
                           top_p=0.8) for p in prompts[:3]]
        eng.drain()
        return [eng.completions[r].tokens for r in rids]

    a, b = run(1), run(1)
    assert a == b
    assert all(0 <= t < tcfg.vocab for row in a for t in row)


@pytest.mark.parametrize("field,value", [
    ("prefill_chunk", 4), ("prefix_cache", True), ("admission", "preempt"),
    ("host_tier", True), ("spec_k", 2), ("fused_sampling", False),
    ("max_retries", 0), ("park_idle_s", 1.0),
])
def test_unported_options_raise(models, field, value):
    _, _, tcfg, tp, prompts = models
    with pytest.raises(NotImplementedError, match=field):
        ServeEngine(tcfg, tp, EngineConfig(**{field: value}), device="cpu")
    with pytest.raises(NotImplementedError, match="deadline"):
        ServeEngine(tcfg, tp, device="cpu").submit(prompts[0], deadline_s=1.0)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main

    eng = main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                "--requests", "3", "--rate", "1000", "--kv-layout", "paged",
                "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "tok/s" in out and eng.stats["status_ok"] == 3


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def _jax_sampling_logits(monkeypatch, logits, temps, top_ks, top_ps):
    """The logits the reference's sampler draws from, captured at its
    ``jax.random.categorical`` call (eager, so the value is concrete)."""
    seen = {}

    def capture(key, z, axis=-1):
        seen["z"] = np.asarray(z)
        return jnp.argmax(z, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    with jax.disable_jit():
        jstep.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0),
                            jnp.asarray(temps), top_ks=jnp.asarray(top_ks),
                            top_ps=jnp.asarray(top_ps))
    return seen["z"]


@pytest.mark.parametrize("ks,ps", [
    ([0, 0, 0, 0], [0.0, 0.0, 0.0, 0.0]),
    ([1, 5, 0, 40], [0.0, 0.0, 0.0, 0.0]),
    ([0, 0, 0, 0], [0.5, 0.9, 1.0, 0.05]),
    ([3, 0, 10, 2], [0.7, 0.3, 0.0, 0.99]),
])
def test_sampling_masks_match_reference(monkeypatch, ks, ps):
    rng = np.random.default_rng(sum(ks) + int(10 * sum(ps)))
    logits = (rng.normal(size=(4, 64)) * 3).astype(np.float32)
    logits[0, :8] = logits[0, 0]                      # ties: stable order matters
    temps = np.array([0.7, 1.0, 1.3, 0.5], np.float32)
    ks, ps = np.array(ks, np.int32), np.array(ps, np.float32)
    want = _jax_sampling_logits(monkeypatch, logits, temps, ks, ps)
    got = tstep.sampling_logits(torch.tensor(logits), torch.tensor(temps),
                                top_ks=torch.tensor(ks), top_ps=torch.tensor(ps)).numpy()
    neg = want <= -1e38
    np.testing.assert_array_equal(got <= -1e38, neg)
    np.testing.assert_allclose(got[~neg], want[~neg], rtol=1e-6)


def test_greedy_and_sampled_rows():
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.normal(size=(5, 50)).astype(np.float32))
    temps = torch.tensor([0.0, 0.8, 0.0, 1.2, 0.0])
    gen = torch.Generator().manual_seed(0)
    tok = tstep.sample_tokens(logits, gen, temps, top_ks=torch.tensor([0, 1, 0, 0, 0],
                                                                      dtype=torch.int32))
    want = jstep.sample_tokens(jnp.asarray(logits.numpy()), jax.random.PRNGKey(0),
                               jnp.zeros(5))
    greedy = logits.argmax(-1)
    assert tok.dtype == torch.int32
    assert tok[[0, 2, 4]].tolist() == np.asarray(want)[[0, 2, 4]].tolist()
    assert tok[1] == greedy[1]                         # top-1 leaves one token
    assert tstep.sample_tokens(logits, gen, torch.zeros(5)).tolist() == \
        np.asarray(want).tolist()


# ---------------------------------------------------------------------------
# Host-side copies
# ---------------------------------------------------------------------------


def test_prompt_buckets_match_reference():
    for max_len in (1, 7, 16, 33, 256, 1024):
        for mb in (1, 4, 16):
            assert prompt_buckets(max_len, mb) == jcache.prompt_buckets(max_len, mb)
            b = prompt_buckets(max_len, mb)
            for plen in range(1, max_len + 1, max(1, max_len // 9)):
                assert bucket_for(plen, b) == jcache.bucket_for(plen, b)
    for bad in ((0, 16), (8, 0)):
        with pytest.raises(ValueError):
            prompt_buckets(*bad)
    with pytest.raises(ValueError):
        bucket_for(9, (4, 8))
    with pytest.raises(ValueError):
        bucket_for(0, (4, 8))


def test_allocator_and_tables_match_reference():
    """The same random walk of alloc / share / free / publish / lookup and
    table appends / releases through both copies: same ids, same state."""
    rng = np.random.default_rng(0)
    ours, theirs = BlockAllocator(9, 4), jpaged.BlockAllocator(9, 4)
    t_ours, t_theirs = SlotTables(3, 4), jpaged.SlotTables(3, 4)
    held = []
    for step in range(300):
        op = rng.integers(0, 10)
        if op < 4 and ours.available:
            b = ours.alloc()
            assert b == theirs.alloc()
            held.append(b)
            slot = int(rng.integers(0, 3))
            if t_ours.mapped(slot) < t_ours.blocks_per_slot:
                t_ours.append(slot, b)
                t_theirs.append(slot, b)
        elif op < 5 and held:
            b = held[int(rng.integers(0, len(held)))]
            ours.share(b), theirs.share(b)
            held.append(b)
        elif op < 7 and held:
            b = held.pop(int(rng.integers(0, len(held))))
            ours.free(b), theirs.free(b)
        elif op < 8 and held:
            key = bytes([step % 7])
            b = held[-1]
            assert ours.publish(b, key) == theirs.publish(b, key)
        elif op < 9:
            keys = [bytes([i]) for i in range(int(rng.integers(0, 4)))]
            assert ours.lookup(keys) == theirs.lookup(keys)
        else:
            slot = int(rng.integers(0, 3))
            assert t_ours.release(slot) == t_theirs.release(slot)
        ours.check()
        np.testing.assert_array_equal(t_ours.table, t_theirs.table)
        assert (ours.num_free, ours.in_use, ours.num_cached, ours.peak_in_use) == (
            theirs.num_free, theirs.in_use, theirs.num_cached, theirs.peak_in_use)
    with pytest.raises(ValueError):
        BlockAllocator(1, 4)
    with pytest.raises(ValueError, match="null"):
        ours.free(0)
    with pytest.raises(ValueError, match="null"):
        t_ours.append(0, 0)
