"""The port's VLM path (the ``vlm`` branch of ``repro_torch.models.lm``) and
the frontend stubs of ``repro_torch.data.pipeline`` against the JAX
reference.

Both packages run the ``internvl2-76b`` smoke config (2 layers, d_model
64, 4/2 heads, 4 image tokens of width 24) on parameters from the JAX
family's ``init`` (converted through numpy) and the same numpy tokens and
patch embeddings: ``forward`` with ``img_embeds`` (the projection
prepended), ``loss_fn`` (the hidden slice from the last image position)
and its gradients, ``prefill`` and ``decode_step`` (continuing at
``frontend_tokens + S``), and the static loop's greedy streams with
``extra``, on both of the port's paths (``attn_impl`` "chunked": plain
PyTorch; "kernel": the flash and RMSNorm wrappers, which run their plain
versions on CPU tensors).  ``make_batch_fn``'s ``patch_embeds`` and
``frames`` extras are bitwise the reference's.

Tolerances.  fp32: 3e-5 absolute plus 1e-5 of each entry: the same fp32
arithmetic in another order (measured at most 2.4e-6 on entries up to
~3.5).  bf16: 2e-2 of each tensor's largest entry: both packages round
the same products to bf16 in another order, a few roundings (2**-8 each)
apart (measured at most 7.4e-3; the reference's own bf16 run is 1.3e-2
from its fp32 run).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import make_batch_fn as jmake_batch_fn
from repro.models import lm as jlm
from repro.serve import ServeConfig as JServeConfig
from repro.serve import generate_static as jgenerate_static
from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
from repro_torch.data import make_batch_fn
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeConfig, generate, generate_static


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its smoke-width ops are too
    small to split, and beside the suite's other workers more threads only
    contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "internvl2-76b"
IMPLS = ["chunked", "kernel"]
DTYPES = ["float32", "bfloat16"]
FP32_TOL = dict(atol=3e-5, rtol=1e-5)
BF16_SHARE = 2e-2


def _np(x):
    return np.array(x.float() if torch.is_tensor(x) else x, np.float32)


def _check(got, want, dt, name=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if dt == "float32":
        np.testing.assert_allclose(got, want, **FP32_TOL, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=0.0,
                                   atol=BF16_SHARE * np.abs(want).max(), err_msg=name)


def _inputs(B=2, S=7, seed=0):
    c = jax_smoke(ARCH)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, c.vocab, (B, S)).astype(np.int32)
    img = rng.normal(size=(B, c.frontend_tokens, c.frontend_dim)).astype(np.float32)
    return toks, img


@pytest.fixture(scope="module")
def jp():
    return jlm.init(jax_smoke(ARCH), jax.random.PRNGKey(0))


def _jcfg(dt="float32"):
    return dataclasses.replace(jax_smoke(ARCH), compute_dtype=dt)


def _port(jp, dt="float32", impl="chunked"):
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype=dt, attn_impl=impl)
    return cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("impl", IMPLS)
def test_forward_with_img_embeds_matches_reference(jp, mesh, rules, dt, impl):
    """The hidden states and KV over the image tokens and the text."""
    toks, img = _inputs()
    cfg, params = _port(jp, dt, impl)
    jh, _, (jk, jv) = jlm.forward(_jcfg(dt), mesh, rules, jp, jnp.asarray(toks),
                                  jnp.asarray(img), remat=False, collect_kv=True)
    th, (tk, tv) = tlm.forward(cfg, tlm.cast_for_compute(cfg, params), torch.tensor(toks),
                               torch.tensor(img), remat=False, collect_kv=True)
    assert th.shape[1] == cfg.frontend_tokens + toks.shape[1]
    for name, got, want in (("hidden", th, jh), ("k", tk, jk), ("v", tv, jv)):
        _check(got, want, dt, name)


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_grads_match_reference(jp, mesh, rules, impl):
    """fp32 ``loss_fn`` with ``patch_embeds`` (``img_proj`` among the
    gradients) against the reference's value and ``jax.grad``."""
    cfg, params = _port(jp, "float32", impl)
    toks, img = _inputs(S=9, seed=1)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(_jcfg(), mesh, rules, p,
                              {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(img)},
                              remat=False), has_aux=True)(jp)
    named = list(_named(params))
    for _, leaf in named:
        leaf.requires_grad_()
    loss, _ = tlm.loss_fn(cfg, params, {"tokens": torch.tensor(toks),
                                        "patch_embeds": torch.tensor(img)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jleaves = [v for _, v in _named(jgrads)]
    assert len(jleaves) == len(named) and "img_proj" in dict(named)
    for (name, leaf), want in zip(named, jleaves):
        np.testing.assert_allclose(_np(leaf.grad), _np(want), **FP32_TOL, err_msg=name)


def _named(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def jax_runs(jp, mesh, rules):
    """The reference's prefill (2 rows of 4 image and 7 text tokens,
    max_len 24) and two decode steps from position 11, fp32 and bf16."""
    toks, img = _inputs()
    nxt = np.array([[3, 7], [250, 1]], np.int32)
    n_ctx = jax_smoke(ARCH).frontend_tokens + toks.shape[1]
    out = {}
    for dt in DTYPES:
        cfg = _jcfg(dt)
        cache, logits = jlm.prefill(cfg, mesh, rules, jp, jnp.asarray(toks), jnp.asarray(img),
                                    max_len=24)
        run = {"prefill": _np(logits), **{f"prefill/{k}": _np(v) for k, v in cache.items()}}
        for i, tok in enumerate(nxt):
            logits, cache = jlm.decode_step(cfg, mesh, rules, jp, cache, jnp.asarray(tok),
                                            n_ctx + i)
            run.update({f"decode{i}": _np(logits),
                        **{f"decode{i}/{k}": _np(v) for k, v in cache.items()}})
        out[dt] = run
    return toks, img, nxt, n_ctx, out


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_reference(jp, jax_runs, dt, impl):
    toks, img, nxt, n_ctx, want = jax_runs
    cfg, params = _port(jp, dt, impl)
    p = tlm.cast_for_compute(cfg, params)
    cache, logits = tlm.prefill(cfg, p, torch.tensor(toks), torch.tensor(img), max_len=24)
    got = {"prefill": logits, **{f"prefill/{k}": v.clone() for k, v in cache.items()}}
    for i, tok in enumerate(nxt):
        logits, cache = tlm.decode_step(cfg, p, cache, torch.tensor(tok), n_ctx + i)
        got.update({f"decode{i}": logits, **{f"decode{i}/{k}": v.clone()
                                             for k, v in cache.items()}})
    assert set(got) == set(want[dt])
    for name, w in want[dt].items():
        _check(got[name], w, dt, name)


@pytest.mark.parametrize("impl", IMPLS)
def test_generate_static_with_extra_matches_reference(jp, mesh, rules, impl):
    """fp32 greedy: ``generate_static`` and ``generate`` with the patch
    embeddings as ``extra`` equal the reference's stream token for token
    (the vlm family is not slot-served)."""
    cfg, params = _port(jp, "float32", impl)
    toks, img = _inputs(seed=2)
    want = np.asarray(jgenerate_static(_jcfg(), mesh, rules, jp, toks, img,
                                       JServeConfig(max_new_tokens=8)))
    for fn in (generate_static, generate):
        got = fn(cfg, params, toks, ServeConfig(max_new_tokens=8), extra=img, device="cpu")
        assert got.shape == (2, 8) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert not treg.supports_slot_serving(cfg) and not treg.supports_paged_serving(cfg)


@pytest.mark.parametrize("arch,key", [(ARCH, "patch_embeds"), ("whisper-tiny", "frames"),
                                      ("smollm-360m", None)])
def test_make_batch_fn_extras_bitwise(arch, key):
    """Tokens and the frontend stub of a seed and step are bitwise the
    reference's arrays (vlm text shortened by its image tokens)."""
    jb = jmake_batch_fn(jax_smoke(arch), JShapeConfig("t", "train", 12, 3), seed=5)
    tb = make_batch_fn(get_smoke_config(arch), ShapeConfig("t", "train", 12, 3), seed=5)
    for step in (0, 7):
        want, got = jb(step), tb(step)
        assert set(got) == set(want) == ({"tokens"} | ({key} if key else set()))
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    if key == "patch_embeds":
        assert got["tokens"].shape == (3, 12 - get_smoke_config(arch).frontend_tokens + 1)


def test_config_and_size():
    """The port's configs are the reference's; a layer of the full model
    holds 855.7 M parameters (1.71 GB in bf16)."""
    from repro.configs import get_config as jax_config

    for get, jget in ((get_config, jax_config), (get_smoke_config, jax_smoke)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    cfg = get_config(ARCH)
    specs = tlm.param_specs(cfg)
    layer = sum(int(np.prod(s.shape[1:])) for s in specs["blocks"].values())
    assert layer == 855_654_400
    assert specs["img_proj"].shape == (3200, 8192)
