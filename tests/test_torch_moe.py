"""The port's MoE layer and the qwen3 MoE family against the JAX reference.

Both packages run the same inputs and the same converted parameters:

* ``expert_capacity`` over a sweep of token counts;
* ``moe_ffn`` against the reference's on a one-device mesh (as
  ``tests/test_moe.py`` runs it), with no drops and with heavy drops
  (capacity factor 0.02): ``drop_frac`` exactly equal, ``lb_loss`` within
  an fp32 ulp (its means sum in another order), the outputs within
  tolerance; the dense oracles of both packages;
* ties: rows and router columns of small integers give exactly equal
  logits, and the port picks the experts ``jax.lax.top_k`` picks;
* the qwen3-moe-30b-a3b smoke model: every prefill and decode entry
  (slotted, paged, a chunked-prefill continuation), logits and cache
  leaves, in fp32; the qwen3-moe-235b-a22b smoke model (rep 3) forward;
* the serve engine's greedy streams and counters against the reference
  engine's on the slotted, paged, and paged with chunked prefill and the
  prefix cache layouts;
* two runs of the port bitwise equal; the registry and the parameter
  trees; the launcher; and ``chip_smoke.py``'s phase 9 rehearsed at smoke
  width.

Tolerances: fp32 1e-5 on one layer and 1e-4 through the model (the same
fp32 arithmetic in another reduction order; ``tests/test_torch_lm.py``'s),
bf16 5e-2 absolute plus 2e-2 relative on one layer (XLA keeps fused
elementwise chains in fp32 where eager PyTorch rounds each op to bf16).
The model-level comparisons run in fp32 only: in bf16 the two packages'
different rounding placement moves a router input by a bf16 ulp, and
where two logits nearly tie that swaps an expert, which is a different
computation, not an error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core.aot import AotCache as JAotCache
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import EngineConfig, ServeEngine

ARCH = "qwen3-moe-30b-a3b"
LAYER_TOL = {"float32": dict(atol=1e-5, rtol=0.0), "bfloat16": dict(atol=5e-2, rtol=2e-2)}
MODEL_TOL = dict(atol=1e-4, rtol=0.0)
NORMS = ("ln1", "ln2", "qnorm", "knorm")
MAX_SLOTS, MAX_LEN, BS = 3, 48, 8
ENGINE_COUNTERS = ("prefills", "prefill_chunks", "prefill_tokens", "prefix_lookup_tokens",
                   "prefix_hit_tokens", "cow_copies", "preemptions", "resumed",
                   "replayed_tokens", "decode_steps")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke-width ops are too small to split."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol=MODEL_TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(), **tol)


def _models(arch=ARCH):
    """(jax cfg, jax params, port cfg, port compute params) of the smoke
    config in fp32, with nonzero norm scales so that every norm counts."""
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    tree = jax.tree.map(np.asarray, jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    for name in NORMS:
        tree["blocks"][name] = (rng.normal(size=tree["blocks"][name].shape) * 0.3
                                ).astype(np.float32)
    tree["ln_f"] = (rng.normal(size=tree["ln_f"].shape) * 0.3).astype(np.float32)
    tp = params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tlm.cast_for_compute(tcfg, tp)


@pytest.fixture(scope="module")
def fp32():
    return _models()


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _impl(cfg, impl):
    return dataclasses.replace(cfg, attn_impl=impl)


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("cf", [None, 0.02, 1.0, 8.0])
def test_expert_capacity_matches_reference(arch, cf):
    for smoke in (True, False):
        jcfg = (jax_smoke if smoke else jax_config)(arch)
        tcfg = (get_smoke_config if smoke else get_config)(arch)
        if cf is not None:
            jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
            tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
        for n in list(range(1, 70)) + [96, 127, 128, 512, 1000, 1024, 4096, 8192, 65536]:
            assert tmoe.expert_capacity(n, tcfg) == jmoe.expert_capacity(n, jcfg), n


def _layer_inputs(cfg, B, S, seed=0):
    D, E, F = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    rw, wg, wu, wd = ((rng.normal(size=s) * 0.1).astype(np.float32)
                      for s in ((D, E), (E, D, F), (E, D, F), (E, F, D)))
    return x, rw, wg, wu, wd


def _both(cfg_t, cfg_j, mesh, rules, arrays, dt):
    """(reference (out, aux), port (out, aux)) of one layer: x in ``dt``,
    weights as given (fp32, cast to ``dt`` inside, as the reference)."""
    x, *w = arrays
    jout, jaux = jax.jit(lambda *a: jmoe.moe_ffn(*a, cfg=cfg_j, mesh=mesh, rules=rules))(
        jnp.asarray(x, dt), *(jnp.asarray(a) for a in w))
    tout, taux = tmoe.moe_ffn(torch.tensor(x).to(getattr(torch, dt)),
                              *(torch.tensor(a) for a in w), cfg=cfg_t)
    return (jout, jaux), (tout, taux)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf,B,S", [(None, 2, 16), ("none", 2, 16), (0.02, 2, 64), (None, 1, 3)])
def test_moe_ffn_matches_reference(mesh, rules, dt, cf, B, S):
    """No drops (capacity factor E), heavy drops (0.02: 8 slots an expert
    for 256 choices), the smoke config's 1.5, and a decode-sized batch of
    3 tokens (the floor of 8 slots)."""
    tcfg, jcfg = get_smoke_config(ARCH), jax_smoke(ARCH)
    if cf is not None:
        cf = float(tcfg.moe.num_experts) if cf == "none" else cf
        tcfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
                      for c in (tcfg, jcfg))
    tcfg, jcfg = (dataclasses.replace(c, compute_dtype=dt) for c in (tcfg, jcfg))
    (jout, jaux), (tout, taux) = _both(tcfg, jcfg, mesh, rules,
                                       _layer_inputs(tcfg, B, S, seed=S), dt)
    assert tout.dtype == getattr(torch, dt) and tout.shape == (B, S, tcfg.d_model)
    assert float(taux["drop_frac"]) == float(jaux["drop_frac"])
    if cf == 0.02:
        assert float(taux["drop_frac"]) > 0.5
    elif cf == tcfg.moe.num_experts:
        assert float(taux["drop_frac"]) == 0.0
    np.testing.assert_allclose(float(taux["lb_loss"]), float(jaux["lb_loss"]), rtol=1e-6)
    _close(jout, tout, LAYER_TOL[dt])


def test_moe_ffn_dense_oracles(mesh, rules):
    """Without drops the port's layer equals its dense oracle, and the
    oracle equals the reference's."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    jcfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    x, *w = _layer_inputs(cfg, 2, 16, seed=4)
    args = [torch.tensor(a) for a in (x, *w)]
    out, aux = tmoe.moe_ffn(*args, cfg=cfg)
    oracle = tmoe.moe_ffn_reference(*args, cfg=cfg)
    assert float(aux["drop_frac"]) == 0.0
    torch.testing.assert_close(out, oracle, atol=1e-5, rtol=0.0)
    _close(jmoe.moe_ffn_reference(*(jnp.asarray(a) for a in (x, *w)), cfg=jcfg), oracle,
           LAYER_TOL["float32"])


def test_topk_ties_pick_the_reference_experts(mesh, rules):
    """Logits that tie exactly (small-integer rows and router columns, two
    columns equal, the rows repeated as padding repeats): the port's top k
    are ``jax.lax.top_k``'s, lower expert first, and so is the layer."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="float32")
    jcfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    D, E, F = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    rng = np.random.default_rng(3)
    rw = rng.integers(-1, 2, (D, E)).astype(np.float32)
    rw[:, 5] = rw[:, 2]
    rw[:, 7] = rw[:, 0]
    rows = rng.integers(-1, 2, (4, D)).astype(np.float32)
    x = np.concatenate([rows, np.repeat(rows[:1], 12, 0), np.zeros((4, D), np.float32)])
    logits = x @ rw
    _, want = jax.lax.top_k(jnp.asarray(logits), cfg.moe.top_k)
    _, _, got = tmoe.route(torch.tensor(x), torch.tensor(rw), cfg.moe.top_k)
    assert np.array_equal(np.asarray(want), got.numpy())
    s = np.sort(logits, axis=1)[:, ::-1]
    assert (s[:, 0] == s[:, 1]).any() and (s[:, 1] == s[:, 2]).any()   # ties are there
    w = [(rng.normal(size=s) * 0.1).astype(np.float32) for s in ((E, D, F), (E, D, F),
                                                               (E, F, D))]
    (jout, jaux), (tout, taux) = _both(cfg, jcfg, mesh, rules, (x[None], rw, *w), "float32")
    assert float(taux["drop_frac"]) == float(jaux["drop_frac"]) > 0.0
    _close(jout, tout, LAYER_TOL["float32"])


def test_moe_ffn_runs_twice_bitwise():
    """Two calls on the same inputs: the same bits (no atomics; the stable
    sort's order is fixed)."""
    cfg = get_smoke_config(ARCH)
    args = [torch.tensor(a).to(torch.bfloat16) for a in _layer_inputs(cfg, 2, 40, seed=9)]
    a, aa = tmoe.moe_ffn(*args, cfg=cfg)
    b, ba = tmoe.moe_ffn(*args, cfg=cfg)
    assert torch.equal(a, b) and all(torch.equal(aa[k], ba[k]) for k in aa)


# ---------------------------------------------------------------------------
# Configs, trees, registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_param_specs_match_reference(arch, smoke):
    jcfg = (jax_smoke if smoke else jax_config)(arch)
    tcfg = (get_smoke_config if smoke else get_config)(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jspecs = jax.tree.map(lambda s: (s.shape, str(s.dtype), s.init_scale),
                          jlm.param_specs(jcfg),
                          is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))
    tspecs = tcommon.map_tree(lambda s: (s.shape, str(s.dtype).split(".")[-1], s.init_scale),
                              tlm.param_specs(tcfg))
    assert jspecs == tspecs
    assert {"router", "wg_e", "wu_e", "wd_e"} <= set(tspecs["blocks"])
    assert not {"wg", "wu", "wd"} & set(tspecs["blocks"])


@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-235b-a22b"])
def test_registry_and_conversion(arch):
    """The family serves as the reference's does, the tree converts whole
    (expert and router leaves under the reference's names), the router
    keeps its stored dtype in the compute tree, and training raises."""
    assert arch in ARCH_IDS
    tcfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    for q in ("supports_slot_serving", "supports_paged_serving", "state_kind",
              "lane_leaf_axes", "recurrent_leaf_axes"):
        assert getattr(treg, q)(tcfg) == getattr(jreg, q)(jcfg), q
    tree = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(1)))
    tp = params_from_numpy(tcfg, tree, device="cpu")
    for path, leaf in tcommon.tree_leaves(tp):
        node = tree
        for k in path:
            node = node[k]
        assert np.array_equal(leaf.numpy(), np.asarray(node, np.float32)), path
    cast = tlm.cast_for_compute(tcfg, tp)
    assert cast["blocks"]["router"].dtype == tp["blocks"]["router"].dtype
    assert cast["blocks"]["wg_e"].dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="MoE training"):
        tlm.loss_fn(tcfg, tp, {"tokens": torch.zeros(1, 5, dtype=torch.int32)})
    with pytest.raises(NotImplementedError, match="vlm"):
        treg.get_module(dataclasses.replace(tcfg, family="vlm"))


# ---------------------------------------------------------------------------
# The model's entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_forward_parity(fp32, mesh, rules, impl):
    """Hidden state, the KV of every layer and the aux (lb summed, drops
    maxed over layers) at S 40; drops happen at the smoke capacity."""
    jcfg, jp, tcfg, tp = fp32
    toks = _tokens(jcfg, (2, 40), 1)
    jh, jaux, (jk, jv) = jlm.forward(jcfg, mesh, rules, jp, jnp.asarray(toks), remat=False,
                                     collect_kv=True)
    aux = {}
    th, (tk, tv) = tlm.forward(_impl(tcfg, impl), tp, torch.tensor(toks), remat=False,
                               collect_kv=True, aux=aux)
    _close(jh, th)
    _close(jk, tk)
    _close(jv, tv)
    assert float(aux["drop_frac"]) == float(jaux["drop_frac"]) > 0.0
    assert float(aux["drop_frac"]) == float(aux["drop_frac_layers"].max())
    assert aux["drop_frac_layers"].shape == (tcfg.n_layers,)
    np.testing.assert_allclose(float(aux["lb_loss"]), float(jaux["lb_loss"]), rtol=1e-5)


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_prefill_slot_and_decode_parity(fp32, mesh, rules, impl):
    """A slotted prefill of 30 positions into lane 1 (its bucket's padding
    routed too), then three decode steps of 2 lanes: logits and both cache
    leaves."""
    jcfg, jp, tcfg, tp = fp32
    cfg = _impl(tcfg, impl)
    toks = _tokens(jcfg, (1, 32), 4)
    jc = {k: jnp.zeros(s.shape, s.dtype) for k, s in jlm.make_cache_specs(jcfg, 2, 48).items()}
    jc, jl = jlm.prefill_slot(jcfg, mesh, rules, jp, jc, jnp.asarray(toks), 1, 30)
    tc = {k: torch.zeros_like(s, device="cpu")
          for k, s in tlm.make_cache_specs(cfg, 2, 48).items()}
    tc, tl = tlm.prefill_slot(cfg, tp, tc, torch.tensor(toks), 1, 30)
    _close(jl, tl)
    idx = np.array([5, 30], np.int32)
    for step in range(3):
        tk = _tokens(jcfg, (2,), 10 + step)
        jl, jc = jlm.decode_step(jcfg, mesh, rules, jp, jc, jnp.asarray(tk), jnp.asarray(idx))
        tl, tc = tlm.decode_step(cfg, tp, tc, torch.tensor(tk), torch.tensor(idx))
        _close(jl, tl)
        idx = idx + 1
    for name in ("k", "v"):
        _close(jc[name], tc[name])


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_paged_entries_parity(fp32, mesh, rules, impl):
    """The first chunk [0, 24) through ``prefill_slot_paged``, a
    continuation [24, 40) (plen 37) through ``prefill_chunk_paged``, then
    a paged decode step of 4 ragged lanes (one stale): logits and every
    pool block but the sink."""
    jcfg, jp, tcfg, tp = fp32
    cfg = _impl(tcfg, impl)
    prompt = _tokens(jcfg, (37,), 5)
    table = np.array([4, 2, 7, 1, 5, 0], np.int32)
    first, cont = np.zeros((1, 24), np.int32), np.zeros((1, 16), np.int32)
    first[0], cont[0, :13] = prompt[:24], prompt[24:]
    NB = 16
    jc = {k: jnp.zeros(s.shape, s.dtype)
          for k, s in jlm.make_paged_cache_specs(jcfg, NB, BS).items()}
    jc, jl0 = jlm.prefill_slot_paged(jcfg, mesh, rules, jp, jc, jnp.asarray(first),
                                     jnp.asarray(table), 37)
    jc, jl1 = jlm.prefill_chunk_paged(jcfg, mesh, rules, jp, jc, jnp.asarray(cont),
                                      jnp.asarray(table), jnp.int32(24), jnp.int32(37))
    tc = {k: torch.zeros_like(s, device="cpu")
          for k, s in tlm.make_paged_cache_specs(cfg, NB, BS).items()}
    tt = torch.tensor(table)
    tc, tl0 = tlm.prefill_slot_paged(cfg, tp, tc, torch.tensor(first), tt, 37)
    tc, tl1 = tlm.prefill_chunk_paged(cfg, tp, tc, torch.tensor(cont), tt, 24, 37)
    _close(jl0, tl0)
    _close(jl1, tl1)
    tables = np.array([[4, 2, 7, 1, 5, 0], [8, 9, 0, 0, 0, 0], [10, 11, 12, 0, 0, 0],
                       [0, 0, 0, 0, 0, 0]], np.int32)
    lengths = np.array([37, 9, 20, 3], np.int32)
    tk = _tokens(jcfg, (4,), 7)
    jl, jc = jlm.decode_step_paged(jcfg, mesh, rules, jp, jc, jnp.asarray(tk),
                                   jnp.asarray(lengths), jnp.asarray(tables), impl="ref")
    tl, tc = tlm.decode_step_paged(cfg, tp, tc, torch.tensor(tk), torch.tensor(lengths),
                                   torch.tensor(tables),
                                   impl="kernel" if impl == "kernel" else "ref")
    _close(jl[:3], tl[:3])                             # lane 3 is stale
    for name in ("k", "v"):
        _close(jc[name][:, 1:], tc[name][:, 1:])


def test_qwen3_235b_smoke_forward(mesh, rules):
    """The 235b smoke model (3 q heads over 1 KV head, 4 experts top-2):
    hidden state and KV."""
    jcfg, jp, tcfg, tp = _models("qwen3-moe-235b-a22b")
    toks = _tokens(jcfg, (2, 24), 2)
    jh, _, (jk, _) = jlm.forward(jcfg, mesh, rules, jp, jnp.asarray(toks), remat=False,
                                 collect_kv=True)
    th, (tk, _) = tlm.forward(_impl(tcfg, "kernel"), tp, torch.tensor(toks), remat=False,
                              collect_kv=True)
    _close(jh, th)
    _close(jk, tk)


# ---------------------------------------------------------------------------
# The serve engine
# ---------------------------------------------------------------------------

ENGINES = {
    "slotted": dict(),
    "paged": dict(kv_layout="paged", page_size=BS),
    "paged_chunked_prefix": dict(kv_layout="paged", page_size=BS, prefill_chunk=BS,
                                 prefix_cache=True),
}


def _stream(vocab, seed=5):
    """(arrival tick, prompt, budget): a shared prefix of 16 (two blocks)
    with tails, and random prompts of 3-29 tokens."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 2 * BS).astype(np.int32)
    out, tick = [], 0
    for i in range(7):
        tick += int(rng.integers(0, 3))
        if i % 3 == 0:
            tail = rng.integers(0, vocab, int(rng.integers(1, 12))).astype(np.int32)
            prompt = np.concatenate([prefix, tail])
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(3, 30))).astype(np.int32)
        out.append((tick, prompt, int(rng.integers(3, 12))))
    return out


def _drive(eng, stream):
    i = tick = 0
    while i < len(stream) or eng.has_work():
        while i < len(stream) and stream[i][0] <= tick:
            _, prompt, budget = stream[i]
            eng.submit(prompt, max_new_tokens=budget, rid=i)
            i += 1
        eng.step()
        eng.check_invariants()
        tick += 1
        assert tick < 500, "engine failed to drain"
    return [list(eng.completions[r].tokens) for r in range(len(stream))]


@pytest.fixture(scope="module")
def plain_streams(fp32):
    _, _, tcfg, tp = fp32
    eng = ServeEngine(tcfg, tp, EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN),
                      device="cpu")
    return _drive(eng, _stream(tcfg.vocab))


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_engine_matches_reference(fp32, mesh, rules, plain_streams, mode):
    """Greedy streams and counters equal the reference engine's on the same
    arrivals (every decode step routes all 3 lanes, idle ones too); where
    prompts prefill whole, the kernel settings' streams equal the plain
    slotted engine's."""
    jcfg, jp, tcfg, tp = fp32
    stream = _stream(tcfg.vocab)
    fields = ENGINES[mode]
    ec = dict(max_slots=MAX_SLOTS, max_len=MAX_LEN, **fields)
    ref = JServeEngine(jcfg, mesh, rules, jp, JEngineConfig(**ec), aot=JAotCache("qwen3-moe"))
    want = _drive(ref, stream)
    cfg = _impl(tcfg, "kernel")
    eng = ServeEngine(cfg, tp, EngineConfig(**ec, paged_attn="kernel"), device="cpu")
    got = _drive(eng, stream)
    assert got == want
    if not fields.get("prefill_chunk"):
        # chunks route (and drop) within their own length, so a chunked
        # prefill is another computation than a whole-bucket one, in the
        # reference too
        assert got == plain_streams
    assert {k: eng.counters[k] for k in ENGINE_COUNTERS} == \
        {k: ref.counters[k] for k in ENGINE_COUNTERS}
    assert all(c.status == "ok" for c in eng.completions.values())
    if mode == "paged_chunked_prefix":
        assert eng.counters["prefix_hit_tokens"] > 0 and eng.counters["prefill_chunks"] > 7


def test_port_runs_bitwise_twice(fp32):
    """Two engines of the port on the same stream: the same streams, and
    the same bits in every cache leaf."""
    _, _, tcfg, tp = fp32
    cfg = dataclasses.replace(_impl(tcfg, "kernel"), compute_dtype="bfloat16")
    params = tlm.cast_for_compute(cfg, tp)
    outs = []
    for _ in range(2):
        eng = ServeEngine(cfg, params, EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN,
                                                    kv_layout="paged", page_size=BS,
                                                    paged_attn="kernel"), device="cpu")
        outs.append((_drive(eng, _stream(cfg.vocab, seed=8)),
                     {k: v.clone() for k, v in eng.state.items()
                      if isinstance(v, torch.Tensor)}))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1].keys() == outs[1][1].keys()
    assert all(torch.equal(outs[0][1][k], outs[1][1][k]) for k in outs[0][1])


def test_launcher_serves_moe_smoke(capsys):
    from repro_torch.launch import serve as launch

    launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "4",
                 "--kv-layout", "paged", "--prefill-chunk", "8", "--prefix-cache"])
    assert "status: ok 4" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 9, rehearsed at smoke width
# ---------------------------------------------------------------------------


def test_chip_smoke_moe_phase(monkeypatch):
    """``chip_smoke.py``'s phase 9 whole at smoke width in bf16 with the
    card's engine settings (8 lanes of 1,024, 16-position pages, phase 3's
    16 requests): full budgets, the graph check (every decode step routes
    all 8 lanes), builds after ``prebuild``, the launch formulas with the
    q and k norms, each prefill's ``drop_frac``, the logits in both dtypes
    and a second run's streams."""
    from test_torch_stablelm import card_stand_ins

    cs = card_stand_ins(monkeypatch, get_smoke_config)
    smoke = get_smoke_config(ARCH)
    monkeypatch.setattr(cs, "MOE_LAYERS", smoke.n_layers)
    monkeypatch.setattr(cs, "MOE_FP32_LAYERS", smoke.n_layers)
    results = {"nvidia_smi": "a CPU rehearsal"}
    launches = cs.moe_path(torch, torch.device("cpu"), results)
    e2e = results["moe"]
    assert e2e["requests"] == 16 and e2e["prefills"] == 16
    assert launches == cs.moe_launches(e2e["prefills"], e2e["decode_steps"])
    assert launches["rmsnorm"] == (3 * smoke.n_layers + 1) * (16 + e2e["decode_steps"])
    assert results["moe_graph_check"]["replays"] == 8
    assert e2e["programs"]["builds"] == 3 + len(e2e["programs"]["buckets"])
    assert e2e["second_run_streams_equal"] and e2e["decode_capacity"] == 8
    drops = e2e["prefill_drop_frac"]
    assert len(drops["max"]) == len(drops["mean"]) == 16
    assert len(drops["layer_mean"]) == smoke.n_layers
    assert all(0.0 <= m <= x < 1.0 for m, x in zip(drops["mean"], drops["max"]))
    assert set(results["moe_logits"]) == {"bfloat16", "float32"}
