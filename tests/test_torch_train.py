"""The port's trainer (``repro_torch.train``, ``models.lm.loss_fn``, the flash
gradient, the data stream, the launcher) against the JAX reference.

Both packages run converted ``smollm-360m`` smoke parameters on the same
numpy tokens.  Tolerances, each with its reason:

* loss and gradients, fp32 compute: loss within 1e-5 relative, gradients
  within 1e-5 + 1e-4 relative — the same fp32 arithmetic in another
  reduction order (measured ~3e-7 absolute on the gradients);
* the same in bf16 compute: loss within 1e-3 relative, each gradient leaf
  within 5e-2 of its largest entry — XLA keeps fused elementwise chains
  in fp32 where eager PyTorch rounds each op's output to bf16, so the
  bf16 weight gradients differ by a few bf16 ulps (2**-8 relative);
* the flash gradient against ``jax.vjp`` of the reference's
  ``chunked_attention``: 3e-5, the same fp32 arithmetic in another order.

The train-step programs against the reference's are in
``test_torch_train_step.py``; the checkpoint manager in
``test_torch_checkpoint.py``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, SyntheticTokens, make_batch_fn
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.flat import tree_from_leaves, tree_leaves

ROOT = Path(__file__).resolve().parents[1]


def _jcfg(dt="float32"):
    return dataclasses.replace(jax_smoke("smollm-360m"), compute_dtype=dt)


def _tcfg(dt="float32", impl="chunked"):
    return dataclasses.replace(get_smoke_config("smollm-360m"), compute_dtype=dt,
                               attn_impl=impl)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module")
def jparams():
    return jlm.init(_jcfg(), jax.random.PRNGKey(0))


def _tparams(jp, dt="float32"):
    return params_from_numpy(_tcfg(dt), jax.tree.map(np.asarray, jp), device="cpu")


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_grads(request, jparams, mesh, rules):
    dt = request.param
    toks = _tokens(256, (4, 33), 0)
    cfg = _jcfg(dt)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(cfg, mesh, rules, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jparams)
    return dt, toks, float(loss), metrics, jax.tree.leaves(grads)


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
@pytest.mark.parametrize("remat", [True, False, "dots"])
def test_loss_and_grads_match_jax(jax_grads, jparams, impl, remat):
    dt, toks, jloss, jmetrics, jgrads = jax_grads
    cfg = _tcfg(dt, impl)
    pairs = list(tree_leaves(_tparams(jparams, dt)))
    xs = [l.requires_grad_() for _, l in pairs]
    loss, metrics = tlm.loss_fn(cfg, tree_from_leaves([p for p, _ in pairs], xs),
                                {"tokens": torch.tensor(toks)}, remat=remat)
    grads = torch.autograd.grad(loss, xs)
    assert float(metrics["lb_loss"]) == float(metrics["drop_frac"]) == 0.0
    assert float(metrics["ce_loss"]) == float(loss)
    if dt == "float32":
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
        for (path, _), a, b in zip(pairs, jgrads, grads):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-4,
                                       err_msg="/".join(path))
    else:
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-3)
        for (path, _), a, b in zip(pairs, jgrads, grads):
            a = np.asarray(a, np.float32)
            scale = max(float(np.abs(a).max()), 1e-6)
            err = float(np.abs(b.float().numpy() - a).max())
            assert err <= 5e-2 * scale, ("/".join(path), err, scale)


def test_remat_recomputes_flash_forward_once_per_layer(jparams, monkeypatch):
    """Under remat the flash forward runs twice per layer (forward, then
    the recompute in the backward); its own backward launches nothing."""
    cfg = _tcfg("float32", "kernel")
    calls = []
    real = flash_ops._forward
    monkeypatch.setattr(flash_ops, "_forward", lambda *a: calls.append(1) or real(*a))
    for remat, per_layer in ((True, 2), (False, 1)):
        calls.clear()
        params = _tparams(jparams)
        for _, l in tree_leaves(params):
            l.requires_grad_()
        loss, _ = tlm.loss_fn(cfg, params, {"tokens": torch.tensor(_tokens(256, (2, 17), 1))},
                              remat=remat)
        loss.backward()
        assert len(calls) == per_layer * cfg.n_layers


def test_remat_recomputes_norms_once_per_layer(jparams, monkeypatch):
    """Under ``attn_impl="kernel"`` every norm of the training forward is
    one call of the RMSNorm wrappers' forward (the kernel on the card):
    per layer ``ln1`` through ``rmsnorm`` and ``ln2`` with its residual add
    through ``rmsnorm_add``, run again by remat's recompute, and ``ln_f``
    once; their backward recomputes through the plain versions and calls
    neither.  ``chip_smoke.py`` phase 4 asserts the same counts on the
    kernels' launches."""
    from repro_torch.kernels.rmsnorm import ops as norm_ops

    cfg = _tcfg("float32", "kernel")
    calls = {"_rmsnorm": 0, "_rmsnorm_add": 0}
    for name in calls:
        real = getattr(norm_ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(norm_ops, name, counted)
    for remat, per_layer in ((True, 2), (False, 1)):
        calls.update(_rmsnorm=0, _rmsnorm_add=0)
        params = _tparams(jparams)
        for _, l in tree_leaves(params):
            l.requires_grad_()
        loss, _ = tlm.loss_fn(cfg, params, {"tokens": torch.tensor(_tokens(256, (2, 17), 1))},
                              remat=remat)
        loss.backward()
        assert calls == {"_rmsnorm": per_layer * cfg.n_layers + 1,
                         "_rmsnorm_add": per_layer * cfg.n_layers}
        assert all(float(params["blocks"][n].grad.abs().sum()) > 0 for n in ("ln1", "ln2"))
        assert float(params["ln_f"].grad.abs().sum()) > 0


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=24),
                                dict(causal=True, softcap=20.0)])
@pytest.mark.parametrize("S,H,Hk,D", [(64, 4, 2, 16), (200, 3, 1, 8)])
def test_flash_gradient_matches_jax_vjp(kw, S, H, Hk, D):
    """The Function's backward is the reference's ``_flash_bwd``: the vjp of
    ``chunked_attention`` with chunks of at most 128."""
    rng = np.random.default_rng(S + H)
    q, k, v = (rng.normal(size=(2, S, h, D)).astype(np.float32) for h in (H, Hk, Hk))
    dout = rng.normal(size=(2, S, H, D)).astype(np.float32)
    chunk = min(128, S)
    _, vjp = jax.vjp(lambda q, k, v: jattn.chunked_attention(
        q, k, v, q_chunk=chunk, kv_chunk=chunk, **kw), q, k, v)
    want = vjp(jnp.asarray(dout))
    xs = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    flash_attention(*xs, **kw).backward(torch.tensor(dout))
    for a, x in zip(want, xs):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(a), atol=3e-5, rtol=3e-5)


# ---------------------------------------------------------------------------
# Data, loop, launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 17)])
def test_synthetic_tokens_bitwise_jax(seed, step):
    want = JSyntheticTokens(JDataConfig(256, 32, 4, seed)).batch(step)
    got = SyntheticTokens(DataConfig(256, 32, 4, seed)).batch(step)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    fn = make_batch_fn(_tcfg(), ShapeConfig("t", "train", 32, 4), seed)
    assert np.array_equal(fn(step)["tokens"], want)


def test_launcher_smoke_cpu_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                          "--arch", "smollm-360m", "--device", "cpu", "--faithful",
                          "--steps", "3"], capture_output=True, text=True, env=env,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout and "skipped steps: 0" in out.stdout


def test_production_meshes_raise():
    from repro_torch.launch.mesh import make_production_mesh
    for multi in (False, True):
        with pytest.raises(NotImplementedError, match="tensor-parallel"):
            make_production_mesh(multi_pod=multi)


def test_trainer_entry_points_raise_without_card(monkeypatch):
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import local_group, single_device_group

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("RANK", raising=False)
    for make in (single_device_group, local_group):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "smollm-360m", "--smoke", "--steps", "1"])
    assert single_device_group("cpu").device == torch.device("cpu")
