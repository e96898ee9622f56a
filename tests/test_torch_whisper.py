"""The port's whisper family (``repro_torch.models.whisper``) against the JAX
reference.

Both packages run the ``whisper-tiny`` smoke config (2 encoder and 2
decoder layers, d_model 48, 3 heads, 16 frames) on parameters from the JAX
family's ``init`` (converted through numpy) and the same numpy tokens and
frames: ``encode``, ``prefill`` (logits and the ``k``/``v``/``xk``/``xv``
cache), ``decode_step`` (logits and the cache after each step), ``loss_fn``
and its gradients, and the static loop's greedy streams, on both of the
port's paths (``attn_impl`` "chunked": plain PyTorch; "kernel": the flash
and RMSNorm wrappers, which run their plain versions on CPU tensors).

Tolerances.  fp32: 3e-5 absolute plus 1e-5 of each entry: the same fp32
arithmetic in another order (measured at most 1.5e-6 on entries up to
~5).  bf16: 2e-2 of each tensor's largest entry: both packages round the
same products to bf16, in another order, a few roundings (2**-8 each)
apart (measured at most 7.1e-3; the reference's own bf16 run is 9e-3 from
its fp32 run).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import whisper as jw
from repro.serve import ServeConfig as JServeConfig
from repro.serve import generate_static as jgenerate_static
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import registry as treg
from repro_torch.models import whisper as tw
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


ARCH = "whisper-tiny"
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
    frames = rng.normal(size=(B, c.enc_seq, c.d_model)).astype(np.float32)
    return toks, frames


@pytest.fixture(scope="module")
def jp():
    return jw.init(jax_smoke(ARCH), jax.random.PRNGKey(0))


def _jcfg(dt="float32"):
    return dataclasses.replace(jax_smoke(ARCH), compute_dtype=dt)


def _port(jp, dt="float32", impl="chunked"):
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype=dt, attn_impl=impl)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, params


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_reference(jp, mesh, rules, dt, impl):
    """The encoder output (sinusoid positions, bidirectional attention)."""
    toks, frames = _inputs()
    cfg, params = _port(jp, dt, impl)
    want = jw.encode(_jcfg(dt), mesh, rules, jp, jnp.asarray(frames))
    got = tw.encode(cfg, tw.cast_for_compute(cfg, params), torch.tensor(frames))
    _check(got, want, dt, "enc_out")


@pytest.fixture(scope="module")
def jax_runs(jp, mesh, rules):
    """The reference's prefill (B = 2, S = 7, max_len 16) and two decode
    steps, fp32 and bf16."""
    toks, frames = _inputs()
    nxt = np.array([[3, 7], [250, 1]], np.int32)
    out = {}
    for dt in DTYPES:
        cfg = _jcfg(dt)
        cache, logits = jw.prefill(cfg, mesh, rules, jp, jnp.asarray(toks),
                                   jnp.asarray(frames), max_len=16)
        run = {"prefill": _np(logits), **{f"prefill/{k}": _np(v) for k, v in cache.items()}}
        for i, tok in enumerate(nxt):
            logits, cache = jw.decode_step(cfg, mesh, rules, jp, cache, jnp.asarray(tok), 7 + i)
            run.update({f"decode{i}": _np(logits),
                        **{f"decode{i}/{k}": _np(v) for k, v in cache.items()}})
        out[dt] = run
    return toks, frames, nxt, out


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_reference(jp, jax_runs, dt, impl):
    """Logits over the padded vocab and the four cache leaves after the
    prefill and after each of two decode steps (``k``/``v`` written in
    place)."""
    toks, frames, nxt, want = jax_runs
    cfg, params = _port(jp, dt, impl)
    p = tw.cast_for_compute(cfg, params)
    cache, logits = tw.prefill(cfg, p, torch.tensor(toks), torch.tensor(frames), max_len=16)
    assert logits.shape[-1] == tw.padded_vocab(cfg) == 256
    got = {"prefill": logits, **{f"prefill/{k}": v.clone() for k, v in cache.items()}}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    for i, tok in enumerate(nxt):
        logits, cache = tw.decode_step(cfg, p, cache, torch.tensor(tok), 7 + i)
        got.update({f"decode{i}": logits, **{f"decode{i}/{k}": v.clone()
                                             for k, v in cache.items()}})
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert set(got) == set(want[dt])
    for name, w in want[dt].items():
        _check(got[name], w, dt, name)


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_grads_match_reference(jp, mesh, rules, impl):
    """fp32 ``loss_fn`` on tokens and frames, and its gradient leaf by leaf
    against the reference's ``jax.grad``."""
    cfg, params = _port(jp, "float32", impl)
    toks, frames = _inputs(S=9, seed=1)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jw.loss_fn(_jcfg(), mesh, rules, p,
                             {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
                             remat=False), has_aux=True)(jp)
    named = list(_named(params))
    for _, leaf in named:
        leaf.requires_grad_()
    loss, aux = tw.loss_fn(cfg, params, {"tokens": torch.tensor(toks),
                                         "frames": torch.tensor(frames)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert aux["lb_loss"].item() == 0.0
    jleaves = [v for _, v in _named(jgrads)]
    assert len(jleaves) == len(named)
    for (name, leaf), want in zip(named, jleaves):
        np.testing.assert_allclose(_np(leaf.grad), _np(want), **FP32_TOL, err_msg=name)


def _named(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("impl", IMPLS)
def test_generate_static_streams_match_reference(jp, mesh, rules, impl):
    """fp32 greedy: ``generate_static`` with the frames equals the
    reference's stream token for token, and ``generate(extra=)`` routes to
    it (whisper is not slot-served)."""
    cfg, params = _port(jp, "float32", impl)
    toks, frames = _inputs(seed=2)
    want = np.asarray(jgenerate_static(_jcfg(), mesh, rules, jp, toks, frames,
                                       JServeConfig(max_new_tokens=8)))
    got = generate_static(cfg, params, toks, ServeConfig(max_new_tokens=8), extra=frames,
                          device="cpu")
    assert got.shape == (2, 8) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        generate(cfg, params, toks, ServeConfig(max_new_tokens=8), extra=frames,
                 device="cpu"), want)
    assert not treg.supports_slot_serving(cfg) and treg.state_kind(cfg) == "kv"


def test_config_and_param_count():
    """The port's configs are the reference's, and the full config's
    parameter tree holds whisper-tiny's 36.5 M parameters (with the
    embedding padded to 51,968 rows)."""
    from repro.configs import get_config as jax_config

    for get, jget in ((get_config, jax_config), (get_smoke_config, jax_smoke)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    cfg = get_config(ARCH)
    specs = [s for _, s in _named(tw.param_specs(cfg))]
    n = sum(int(np.prod(s.shape)) for s in specs)
    assert tw.padded_vocab(cfg) == 51_968 and 36.0e6 < n < 37.0e6


def test_launcher_static_on_cpu(capsys):
    """``--engine static`` serves the batch with frames drawn from the seed;
    the continuous default falls back to the static loop, as the
    reference's launcher does."""
    from repro_torch.launch.serve import main

    out = main(["--arch", ARCH, "--smoke", "--device", "cpu", "--engine", "static",
                "--batch", "2", "--new-tokens", "4"])
    assert out.shape == (2, 4)
    again = main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                  "--new-tokens", "4"])
    np.testing.assert_array_equal(out, again)
    text = capsys.readouterr().out
    assert "has no slot-serving support; falling back to the static loop" in text
    assert text.count("seq1: ") == 2
