"""The port's dense LM (``repro_torch.models``) against the JAX reference.

Both packages run the same converted ``smollm-360m`` smoke parameters on
the same numpy inputs: prefill (slotted and paged), decode (slotted and
paged, plain and kernel attention — the kernel wrappers run their plain
versions on CPU tensors), plus the numerics the blocks are built from.

Tolerances.  fp32 compute: 1e-4 absolute on logits and caches whose
entries are O(1) — the frameworks run the same fp32 arithmetic and differ
only in reduction order and transcendental implementations (measured
~2e-6).  bf16 compute: 5e-2 absolute plus 2e-2 relative — XLA keeps fused
elementwise chains in fp32 where eager PyTorch rounds each op's output to
bf16, a few bf16 ulps (2**-8 relative) at O(1) values (measured ~3e-2).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.models.convert import params_from_numpy

TOL = {"float32": dict(atol=1e-4, rtol=0.0),
       "bfloat16": dict(atol=5e-2, rtol=2e-2)}


def _close(a, b, dt):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.float().numpy(), **TOL[dt])


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(dtype, jax cfg, jax params, port cfg, port compute params)."""
    dt = request.param
    jcfg = dataclasses.replace(jax_smoke("smollm-360m"), compute_dtype=dt)
    tcfg = dataclasses.replace(get_smoke_config("smollm-360m"), compute_dtype=dt)
    jp = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return dt, jcfg, jp, tcfg, tlm.cast_for_compute(tcfg, tp)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


@pytest.fixture(scope="module")
def jax_out(pair, mesh, rules):
    """The reference's outputs, run once per dtype and shared by the impls."""
    _, jcfg, jp, _, _ = pair
    memo = {}

    def get(name, fn):
        if name not in memo:
            memo[name] = fn(jcfg, jp)
        return memo[name]

    get.mesh, get.rules = mesh, rules
    return get


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_prefill_slot_parity(pair, jax_out, impl):
    dt, jcfg, jp, tcfg, tp = pair
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    toks = _tokens(jcfg, (1, 32), 1)

    def ref(jcfg, jp):
        jc = {k: jnp.zeros(s.shape, s.dtype)
              for k, s in jlm.make_cache_specs(jcfg, 2, 64).items()}
        return jlm.prefill_slot(jcfg, jax_out.mesh, jax_out.rules, jp, jc,
                                jnp.asarray(toks), 1, 27)

    jc, jl = jax_out("prefill_slot", ref)
    tc = {k: torch.zeros_like(s, device="cpu")
          for k, s in tlm.make_cache_specs(tcfg, 2, 64).items()}
    tc, tl = tlm.prefill_slot(tcfg, tp, tc, torch.tensor(toks), 1, 27)
    _close(jl, tl, dt)
    for name in ("k", "v"):
        _close(jc[name], tc[name], dt)


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_prefill_slot_paged_parity(pair, jax_out, impl):
    dt, jcfg, jp, tcfg, tp = pair
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    toks = _tokens(jcfg, (1, 32), 2)
    table = np.array([3, 1, 0, 0], np.int32)     # 2 mapped blocks of 16

    def ref(jcfg, jp):
        jc = {k: jnp.zeros(s.shape, s.dtype)
              for k, s in jlm.make_paged_cache_specs(jcfg, 6, 16).items()}
        return jlm.prefill_slot_paged(jcfg, jax_out.mesh, jax_out.rules, jp, jc,
                                      jnp.asarray(toks), jnp.asarray(table), 20)

    jc, jl = jax_out("prefill_slot_paged", ref)
    tc = {k: torch.zeros_like(s, device="cpu")
          for k, s in tlm.make_paged_cache_specs(tcfg, 6, 16).items()}
    tc, tl = tlm.prefill_slot_paged(tcfg, tp, tc, torch.tensor(toks),
                                    torch.tensor(table), 20)
    _close(jl, tl, dt)
    # every block but the sink (whose content depends on write order)
    for name in ("k", "v"):
        _close(jc[name][:, 1:], tc[name][:, 1:], dt)


def test_decode_step_parity(pair, mesh, rules):
    """Three decode steps with per-lane positions after a prefill."""
    dt, jcfg, jp, tcfg, tp = pair
    toks = _tokens(jcfg, (1, 32), 3)
    jc = {k: jnp.zeros(s.shape, s.dtype)
          for k, s in jlm.make_cache_specs(jcfg, 2, 64).items()}
    jc, _ = jlm.prefill_slot(jcfg, mesh, rules, jp, jc, jnp.asarray(toks), 1, 27)
    tc = {k: torch.zeros_like(s, device="cpu")
          for k, s in tlm.make_cache_specs(tcfg, 2, 64).items()}
    tc, _ = tlm.prefill_slot(tcfg, tp, tc, torch.tensor(toks), 1, 27)
    idx = np.array([5, 27], np.int32)
    jstep = jax.jit(functools.partial(jlm.decode_step, jcfg, mesh, rules))
    for step in range(3):
        tk = _tokens(jcfg, (2,), 10 + step)
        jl, jc = jstep(jp, jc, jnp.asarray(tk), jnp.asarray(idx))
        tl, tc = tlm.decode_step(tcfg, tp, tc, torch.tensor(tk), torch.tensor(idx))
        _close(jl, tl, dt)
        idx = idx + 1
    _close(jc["k"], tc["k"], dt)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_decode_step_paged_parity(pair, jax_out, impl):
    """Paged decode against the reference's paged decode ("ref" path) on
    ragged lanes: one mid-block, one crossing into a fresh block, one
    stale lane with a nulled table."""
    dt, jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(4)
    NB, bs = 9, 4
    shape = (jcfg.n_layers, NB, bs, jcfg.n_kv, jcfg.head_dim)
    pool = rng.normal(size=(2,) + shape).astype(np.float32)
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    lengths = np.array([9, 8, 6], np.int32)
    tc = {"k": torch.tensor(pool[0]).to(getattr(torch, dt)),
          "v": torch.tensor(pool[1]).to(getattr(torch, dt))}
    tk = _tokens(jcfg, (3,), 5)

    def ref(jcfg, jp):
        jc = {"k": jnp.asarray(pool[0], dt), "v": jnp.asarray(pool[1], dt)}
        return jlm.decode_step_paged(jcfg, jax_out.mesh, jax_out.rules, jp, jc,
                                     jnp.asarray(tk), jnp.asarray(lengths),
                                     jnp.asarray(tables), impl="ref")

    jl, jc = jax_out("decode_step_paged", ref)
    tl, tc = tlm.decode_step_paged(tcfg, tp, tc, torch.tensor(tk),
                                   torch.tensor(lengths), torch.tensor(tables),
                                   impl=impl)
    _close(jl[:2], tl[:2], dt)          # lane 2 is stale: its output is discarded
    for name in ("k", "v"):
        _close(jc[name][:, 1:], tc[name][:, 1:], dt)


def test_param_specs_match_reference():
    jshapes = jax.tree.map(lambda s: s.shape, jlm.param_specs(jax_smoke("smollm-360m")),
                           is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))
    tshapes = tcommon.map_tree(lambda s: s.shape,
                               tlm.param_specs(get_smoke_config("smollm-360m")))
    assert jshapes == tshapes


def test_full_width_config_matches_reference():
    from repro.configs import get_config as jget
    assert dataclasses.asdict(jget("smollm-360m")) == dataclasses.asdict(
        get_config("smollm-360m"))


def test_init_shapes_and_scales():
    cfg = get_smoke_config("smollm-360m")
    p = tlm.init(cfg, seed=0, device="cpu")
    assert torch.equal(p["blocks"]["ln1"], torch.zeros(cfg.n_layers, cfg.d_model))
    wq = p["blocks"]["wq"]
    assert wq.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)
    # fan-in normal: std 1/sqrt(d_model)
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    again = tlm.init(cfg, seed=0, device="cpu")
    assert torch.equal(p["embed"], again["embed"])
    assert not torch.equal(p["embed"], tlm.init(cfg, seed=1, device="cpu")["embed"])


def test_params_from_numpy_rejects_mismatch():
    cfg = get_smoke_config("smollm-360m")
    tree = tcommon.map_tree(lambda t: t.numpy(), tlm.init(cfg, 0, "cpu"))
    tree["blocks"]["wq"] = tree["blocks"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(cfg, tree, device="cpu")
    del tree["blocks"]["wq"]
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_registry_answers_match_reference(arch):
    """Every architecture of the reference resolves to the port's module of
    the same name, and the serving questions (slot and paged serving,
    state kind, recurrent leaves and their lane axes) get the reference
    registry's answers, for the full and the smoke config."""
    for get, jget in ((get_config, jax_config), (get_smoke_config, jax_smoke)):
        cfg, jcfg = get(arch), jget(arch)
        assert cfg.family == jcfg.family
        assert treg.get_module(cfg).__name__.rsplit(".", 1)[1] == \
            jreg.get_module(jcfg).__name__.rsplit(".", 1)[1]
        assert treg.supports_slot_serving(cfg) == jreg.supports_slot_serving(jcfg)
        assert treg.supports_paged_serving(cfg) == jreg.supports_paged_serving(jcfg)
        assert treg.state_kind(cfg) == jreg.state_kind(jcfg)
        assert treg.recurrent_leaf_axes(cfg) == jreg.recurrent_leaf_axes(jcfg)
        assert treg.lane_leaf_axes(cfg) == jreg.lane_leaf_axes(jcfg)
    assert arch in ARCH_IDS
    # a moe config needs experts (lm serves the moe family)
    moe = dataclasses.replace(get_smoke_config("smollm-360m"), family="moe")
    with pytest.raises(ValueError, match="experts"):
        treg.get_module(moe).param_specs(moe)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rope_and_rms_norm(dt):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    g = (rng.normal(size=(16,)) * 0.1).astype(np.float32)
    jx = jnp.asarray(x, dt)
    tx = torch.tensor(x).to(getattr(torch, dt))
    _close(jattn.rope(jx, jnp.asarray(pos)), tattn.rope(tx, torch.tensor(pos)), dt)
    _close(jcommon.rms_norm(jx, jnp.asarray(g)),
           tcommon.rms_norm(tx, torch.tensor(g)), dt)
    np.testing.assert_allclose(
        np.asarray(jcommon.softcap(jnp.asarray(x), 5.0)),
        tcommon.softcap(torch.tensor(x), 5.0).numpy(), atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(jcommon.decode_positions(jnp.asarray([3, 4]), 2)),
        tcommon.decode_positions(torch.tensor([3, 4]), 2).numpy())
    assert tcommon.decode_positions(7, 3).tolist() == [[7], [7], [7]]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_qk_norm_prefill_and_decode_parity(mesh, rules, dt, impl):
    """QK-RMSNorm (``qk_norm=True``, qwen3's) on the dense smoke config,
    with random nonzero ``qnorm``/``knorm`` scales: a slotted prefill and
    one decode step against the reference.  Under ``impl="kernel"`` the
    q and k norms go through the RMSNorm wrapper (its plain version on
    CPU tensors), as every other norm does."""
    jcfg = dataclasses.replace(jax_smoke("smollm-360m"), compute_dtype=dt, qk_norm=True)
    tcfg = dataclasses.replace(get_smoke_config("smollm-360m"), compute_dtype=dt,
                               qk_norm=True, attn_impl=impl)
    jp = jax.tree.map(np.asarray, jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(8)
    for name in ("qnorm", "knorm"):
        jp["blocks"][name] = (rng.normal(size=jp["blocks"][name].shape) * 0.3).astype(np.float32)
    tp = tlm.cast_for_compute(tcfg, params_from_numpy(tcfg, jp, device="cpu"))
    jp = jax.tree.map(jnp.asarray, jp)
    toks = _tokens(jcfg, (1, 32), 2)
    jc = {k: jnp.zeros(s.shape, s.dtype) for k, s in jlm.make_cache_specs(jcfg, 2, 64).items()}
    jc, jl = jlm.prefill_slot(jcfg, mesh, rules, jp, jc, jnp.asarray(toks), 1, 27)
    tc = {k: torch.zeros_like(s, device="cpu")
          for k, s in tlm.make_cache_specs(tcfg, 2, 64).items()}
    tc, tl = tlm.prefill_slot(tcfg, tp, tc, torch.tensor(toks), 1, 27)
    _close(jl, tl, dt)
    _close(jc["k"], tc["k"], dt)
    tk, idx = _tokens(jcfg, (2,), 9), np.array([3, 27], np.int32)
    jl, _ = jlm.decode_step(jcfg, mesh, rules, jp, jc, jnp.asarray(tk), jnp.asarray(idx))
    tl, _ = tlm.decode_step(tcfg, tp, tc, torch.tensor(tk), torch.tensor(idx))
    _close(jl, tl, dt)
