"""The port's SSD scan and Mamba2 block (``repro_torch.models.ssm``,
``repro_torch.kernels.ssd``) against the JAX reference's jnp oracles.

On this CPU box the SSD kernel's wrappers run their plain versions (the
tensors lie on the CPU); those and the model's ``ssd_chunked`` are held
against the reference's ``kernels/ssd/ref.ssd_ref`` (the step recurrence)
and ``models/ssm.ssd_chunked`` over the sweep of ``tests/test_kernels.py``
— never against the Pallas kernel in interpret mode.  The CUDA kernel is
held against the plain version by the ``cuda``-marked cases of
``tests/test_torch_kernels.py``.

Tolerances.  The scan against the oracles: the reference's own, fp32 2e-4
(the chunked form against the step recurrence: the same sums in another
order over up to 128 steps) and bf16 5e-2 (inputs rounded to bf16, the TPU
layout's output rounded once more).  The Mamba2 block against the
reference's: fp32 1e-4 absolute plus 1e-5 of each entry (the SSM state's
entries reach ~10); bf16 5e-2 of the output's largest entry — eager
PyTorch rounds each op's output to bf16 where XLA keeps fused chains in
fp32, a bf16 ulp (2**-8 relative) or two per op.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref
from repro.models import ssm as jssm
from repro.models import zamba as jzamba
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssd import ref as tref
from repro_torch.kernels.ssd.ops import ssd, ssd_fwd
from repro_torch.models import ssm as tssm
from repro_torch.models import zamba as tzamba
from repro_torch.models.convert import params_from_numpy

DTYPES = ["float32", "bfloat16"]
SWEEP = [(64, 4, 16, 2, 8, 16), (128, 2, 8, 1, 16, 32), (32, 8, 32, 4, 4, 8)]  # T,H,P,G,N,chunk


def _tol(dt):
    return dict(atol=5e-2, rtol=5e-2) if dt == "bfloat16" else dict(atol=2e-4, rtol=2e-4)


def _sweep_inputs(T, H, P, G, N):
    """The TPU layout's inputs of ``tests/test_kernels.py::test_ssd_sweep``."""
    rng = np.random.default_rng(T + H)
    return (rng.normal(size=(2, H, T, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(2, H, T)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            rng.normal(size=(2, G, T, N)).astype(np.float32),
            rng.normal(size=(2, G, T, N)).astype(np.float32))


def _model_inputs(B, T, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(B, T, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            rng.normal(size=(B, T, G, N)).astype(np.float32),
            rng.normal(size=(B, T, G, N)).astype(np.float32))


def _t(x, dt="float32"):
    return torch.tensor(x).to(getattr(torch, dt))


def _j(x, dt="float32"):
    return jnp.asarray(x, dt)


def _pair(xs, dt):
    """(jax, torch) versions of the scan inputs: x, B, C in ``dt``; dt and A
    in fp32."""
    x, d, A, Bm, Cm = xs
    return ((_j(x, dt), _j(d), _j(A), _j(Bm, dt), _j(Cm, dt)),
            (_t(x, dt), _t(d), _t(A), _t(Bm, dt), _t(Cm, dt)))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("T,H,P,G,N,chunk", SWEEP)
def test_ssd_fwd_plain_matches_ssd_ref(dt, T, H, P, G, N, chunk):
    """The TPU layout's wrapper (plain version on CPU) against the
    reference's recurrence oracle, as ``test_kernels.py::test_ssd_sweep``
    holds the Pallas kernel."""
    js, ts = _pair(_sweep_inputs(T, H, P, G, N), dt)
    y = ssd_fwd(*ts, chunk=chunk)
    assert y.dtype == getattr(torch, dt) and y.shape == (2, H, T, P)
    _close(y, j_ssd_ref(*js), **_tol(dt))
    _close(tref.ssd_ref(*ts), j_ssd_ref(*js), **_tol(dt))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("T,H,P,G,N,chunk", SWEEP)
def test_ssd_chunked_matches_reference(dt, T, H, P, G, N, chunk):
    """The model layout: the port's ``ssd_chunked`` against the reference's,
    and the model-layout wrapper (plain on CPU) with its final state."""
    js, ts = _pair(_model_inputs(2, T, H, P, G, N, seed=T), dt)
    want, want_s = jssm.ssd_chunked(*js, chunk=chunk, return_state=True)
    y = tssm.ssd_chunked(*ts, chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (2, T, H, P)
    _close(y, want, **_tol("float32"))
    y2, s2 = ssd(*ts, chunk=chunk)
    _close(y2, want, **_tol("float32"))
    _close(s2, want_s, **_tol("float32"))
    assert s2.shape == (2, H, N, P)


@pytest.mark.parametrize("T,chunk", [(37, 16), (5, 8), (64, 64), (100, 32)])
def test_ssd_ragged_and_return_state(T, chunk):
    """T % chunk != 0 (dt = 0 padding) and T < chunk (Q = T): y and the
    final state against the reference's ``ssd_chunked`` and against the
    port's step recurrence."""
    js, ts = _pair(_model_inputs(1, T, 4, 8, 2, 8, seed=T), "float32")
    want, want_s = jssm.ssd_chunked(*js, chunk=chunk, return_state=True)
    y, s = tssm.ssd_chunked(*ts, chunk=chunk, return_state=True)
    _close(y, want, **_tol("float32"))
    _close(s, want_s, **_tol("float32"))
    _close(tssm.ssd_reference(*ts), np.asarray(jssm.ssd_reference(*js)), **_tol("float32"))
    _close(y, np.asarray(jssm.ssd_reference(*js)), **_tol("float32"))


def test_ssd_dt_zero_tail_is_identity():
    """A tail of dt = 0 steps leaves the state bitwise as it was: the
    padded prefill bucket snapshots the real prompt end."""
    x, d, A, Bm, Cm = _model_inputs(1, 24, 4, 8, 1, 8, seed=3)
    d_pad = d.copy()
    d_pad[:, 16:] = 0.0
    _, s_exact = tssm.ssd_chunked(*(_t(a) for a in (x[:, :16], d[:, :16], A, Bm[:, :16],
                                                       Cm[:, :16])), chunk=8, return_state=True)
    _, s_pad = tssm.ssd_chunked(*(_t(a) for a in (x, d_pad, A, Bm, Cm)), chunk=8,
                                return_state=True)
    assert torch.equal(s_exact, s_pad)


def test_ssd_final_state_continues_decode():
    """prefill state -> decode steps equal one long scan (the counterpart of
    ``test_recurrent_cells.py::test_ssd_final_state_continues_decode``),
    and each decode step equals the reference's."""
    xs = _model_inputs(1, 24, 2, 4, 1, 4)
    js, ts = _pair(xs, "float32")
    ref = np.asarray(jssm.ssd_reference(*js))
    _, S = tssm.ssd_chunked(*(a[:, :16] if a.dim() > 1 else a for a in ts), chunk=8,
                            return_state=True)
    _, jS = jssm.ssd_chunked(*(a[:, :16] if a.ndim > 1 else a for a in js), chunk=8,
                             return_state=True)
    x, d, A, Bm, Cm = ts
    jx, jd, jA, jB, jC = js
    for t in range(16, 24):
        S, yt = tssm.ssd_decode_step(S, x[:, t], d[:, t], A, Bm[:, t], Cm[:, t])
        jS, jyt = jssm.ssd_decode_step(jS, jx[:, t], jd[:, t], jA, jB[:, t], jC[:, t])
        _close(yt, ref[:, t], **_tol("float32"))
        _close(yt, jyt, **_tol("float32"))
        _close(S, jS, **_tol("float32"))


def test_ssd_wrappers_reject_bad_inputs():
    x, d, A, Bm, Cm = (_t(a) for a in _model_inputs(1, 8, 4, 8, 2, 8))
    with pytest.raises(ValueError, match="multiple of groups"):
        ssd(x, d, A, Bm[:, :, :1].expand(1, 8, 3, 8), Cm[:, :, :1].expand(1, 8, 3, 8),
            chunk=4)
    with pytest.raises(TypeError, match="float32"):
        ssd(x, d.double(), A, Bm, Cm, chunk=4)
    with pytest.raises(TypeError, match="share"):
        ssd(x, d, A, Bm.bfloat16(), Cm, chunk=4)
    with pytest.raises(ValueError, match="do not match"):
        ssd(x, d[:, :4], A, Bm, Cm, chunk=4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssd(*(a.to("meta") for a in (x, d, A, Bm, Cm)), chunk=4)


# ---------------------------------------------------------------------------
# The Mamba2 block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=DTYPES)
def block(request):
    """(dtype, jax cfg, jax layer-0 params, port cfg, port layer-0 params)
    at the zamba2 smoke width, parameters from the JAX family's init."""
    dt = request.param
    jcfg = dataclasses.replace(jax_smoke("zamba2-1.2b"), compute_dtype=dt)
    tcfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"), compute_dtype=dt)
    jp = jzamba.init(jcfg, jax.random.PRNGKey(1))
    # non-trivial values for the zero-initialised leaves
    rng = np.random.default_rng(4)
    for name in ("ln", "conv_b", "dt_bias", "A_log", "D_skip", "out_ln"):
        jp["mamba"][name] = jnp.asarray(
            rng.normal(size=jp["mamba"][name].shape).astype(np.float32) * 0.3)
    tp = tzamba.cast_for_compute(
        tcfg, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return (dt, jcfg, jax.tree.map(lambda a: a[0], jp["mamba"]), tcfg,
            tzamba._layer(tp, 0))


def _block_tol(dt, want):
    if dt == "bfloat16":
        return dict(atol=5e-2 * float(np.abs(np.asarray(want, np.float32)).max()), rtol=0.0)
    return dict(atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
@pytest.mark.parametrize("plen", [None, 9])
def test_mamba_block_fwd_matches_reference(block, rules, impl, plen):
    """Prefill block: output, SSM state and conv state; with ``plen`` the
    padded bucket's states (dt = 0 past plen, conv state sliced at plen)."""
    dt, jcfg, jbp, tcfg, tbp = block
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    x = np.random.default_rng(5).normal(size=(1, 16, jcfg.d_model)).astype(np.float32)
    valid = None if plen is None else np.arange(16)[None] < plen
    jo, (js_, jc) = jssm.mamba_block_fwd(
        jcfg, rules, _j(x, dt), jbp, return_state=True,
        valid=None if valid is None else jnp.asarray(valid), state_len=plen)
    to, (ts_, tc) = tssm.mamba_block_fwd(
        tcfg, _t(x, dt), tbp, return_state=True,
        valid=None if valid is None else torch.tensor(valid), state_len=plen)
    for got, want in ((to, jo), (ts_, js_), (tc, jc)):
        assert got.shape == want.shape
        _close(got, want, **_block_tol(dt, want))


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_mamba_block_decode_matches_reference(block, rules, impl):
    dt, jcfg, jbp, tcfg, tbp = block
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    rng = np.random.default_rng(6)
    _, H, conv_ch = tssm.mamba_dims(tcfg)
    s = tcfg.ssm
    x = rng.normal(size=(3, jcfg.d_model)).astype(np.float32)
    S = rng.normal(size=(3, H, s.state, s.head_dim)).astype(np.float32)
    conv = rng.normal(size=(3, s.conv_kernel - 1, conv_ch)).astype(np.float32)
    jo, jS, jc = jssm.mamba_block_decode(jcfg, rules, _j(x, dt), jbp, _j(S),
                                         _j(conv, dt))
    to, tS, tc = tssm.mamba_block_decode(tcfg, _t(x, dt), tbp, _t(S), _t(conv, dt))
    for got, want in ((to, jo), (tS, jS), (tc, jc)):
        _close(got, want, **_block_tol(dt, want))


def test_causal_conv_state_len_matches_reference():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 10, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 6)).astype(np.float32)
    for kw in (dict(), dict(state=st), dict(state_len=7), dict(state_len=1)):
        jkw = {k: (_j(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        jy, js_ = jssm._causal_conv(_j(x), _j(w), _j(b), **jkw)
        ty, ts_ = tssm._causal_conv(_t(x), _t(w), _t(b), **tkw)
        _close(ty, jy, atol=1e-6, rtol=1e-6)
        _close(ts_, js_, atol=0.0, rtol=0.0)
