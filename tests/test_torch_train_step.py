"""The port's train-step programs (``repro_torch.train.step``) and loop
against the JAX reference's ``build_train_step``.

Both packages run converted ``smollm-360m`` smoke parameters in fp32
compute on the same numpy tokens, for three steps of Adam at lr 1e-3.
Losses agree within 1e-5 relative and grad norms within 1e-4 (the same
fp32 arithmetic in another reduction order).  Parameters are held to
``3 lr`` absolute, with at most 0.1% of elements more than ``5e-5`` (5% of
lr) apart: Adam's first step moves every parameter by about ±lr whatever
the gradient's size, so where a gradient entry is near zero the two
frameworks' last-bit differences can move that element anywhere in
[-lr, lr] (measured: 1 element in 18,432 of one leaf, 0.2 lr apart).
The same check with §5.1 slicing is ``test_torch_train_slices.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.mesh import local_mesh, single_device_mesh
from repro.models import lm as jlm
from repro.models.common import ShardRules
from repro.optim import OptConfig as JOptConfig
from repro.train.step import TrainSettings as JTrainSettings
from repro.train.step import build_train_step as j_build_train_step
from repro.train.step import opt_state_template as j_opt_state_template
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import single_device_group
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import OptConfig
from repro_torch.optim.flat import flatten, tree_leaves
from repro_torch.train import LoopConfig, TrainSettings, build_train_step, train
from repro_torch.train.step import flat_engine_mode, flat_layout_for, opt_state_template

CPU = single_device_group("cpu")
LR = 1e-3


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


def assert_params_close(got, want, path=""):
    """``3 lr`` everywhere, and at most 0.1% of elements beyond 5e-5."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    assert diff.max() <= 3 * LR, (path, float(diff.max()))
    assert np.mean(diff > 5e-5) <= 1e-3, (path, float(np.mean(diff > 5e-5)))


# ---------------------------------------------------------------------------
# Train steps against the reference's build_train_step
# ---------------------------------------------------------------------------


def _jax_program(mode):
    if mode == "zero":           # the reference's ZeRO needs exactly one data axis
        mesh = local_mesh()
        return mesh, ShardRules.for_mesh(mesh), JTrainSettings(flat_engine="zero")
    mesh = single_device_mesh()
    return (mesh, ShardRules.for_mesh(mesh, faithful=mode == "faithful"),
            JTrainSettings(faithful=mode == "faithful",
                           flat_engine="off" if mode == "off" else "auto"))


def _port_settings(mode, k):
    return TrainSettings(num_slices=k, faithful=mode == "faithful",
                         flat_engine={"zero": "zero", "off": "off"}.get(mode, "auto"))


def check_against_jax(jparams, mode, k):
    """Three steps of ``mode`` with ``num_slices=k`` in both packages."""
    jcfg, tcfg = _jcfg(), _tcfg()
    mesh, rules, jset = _jax_program(mode)
    jset = dataclasses.replace(jset, num_slices=k)
    jopt, topt = JOptConfig(kind="adam", lr=LR, bucket_mb=0.05), \
        OptConfig(kind="adam", lr=LR, bucket_mb=0.05)
    jstep = jax.jit(j_build_train_step(jcfg, mesh, rules, jopt, jset))
    jinit, _ = j_opt_state_template(jcfg, mesh, rules, jopt, jset)
    tset = _port_settings(mode, k)
    tstep = build_train_step(tcfg, CPU, topt, tset)
    assert tstep._flat_engine == (None if mode == "off" else mode)
    jp, jo = jparams, jinit(jparams)
    tp = _tparams(jparams)
    to = opt_state_template(tcfg, CPU, topt, tset)(tp)
    for i in range(3):
        toks = _tokens(256, (4, 17), 10 + i)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(toks)})
        tp, to, tm = tstep(tp, to, {"tokens": toks})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
    assert int(to["step"]) == int(jo["step"]) == 3
    for a, (path, b) in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        assert_params_close(b.numpy(), a, "/".join(path))


@pytest.mark.parametrize("mode", ["faithful", "zero", "off"])
def test_train_step_matches_jax(jparams, mode):
    check_against_jax(jparams, mode, k=1)


def test_flat_engine_mode_gating_matches_jax():
    cfg = _tcfg()
    adam, sgd = OptConfig(kind="adam"), OptConfig(kind="sgd")
    assert flat_engine_mode(cfg, CPU, adam, TrainSettings(faithful=True)) == "faithful"
    assert flat_engine_mode(cfg, CPU, adam, TrainSettings(flat_engine="zero")) == "zero"
    assert flat_engine_mode(cfg, CPU, adam, TrainSettings()) is None
    assert flat_engine_mode(cfg, CPU, sgd, TrainSettings(faithful=True)) is None
    with pytest.raises(ValueError, match="requires adam/adamw"):
        flat_engine_mode(cfg, CPU, sgd, TrainSettings(flat_engine="zero"))
    with pytest.raises(ValueError, match="conflicts with faithful"):
        flat_engine_mode(cfg, CPU, adam, TrainSettings(faithful=True, flat_engine="zero"))
    with pytest.raises(ValueError, match="flat_engine"):
        flat_engine_mode(cfg, CPU, adam, TrainSettings(flat_engine="on"))
    assert JTrainSettings().__dict__ == TrainSettings().__dict__


@pytest.mark.parametrize("mode", ["faithful", "zero"])
def test_skip_step_is_bitwise_noop(jparams, mode):
    cfg = _tcfg()
    opt = OptConfig(kind="adam", lr=1e-3, bucket_mb=0.05)
    tset = _port_settings(mode, 1)
    step = build_train_step(cfg, CPU, opt, tset)
    params = _tparams(jparams)
    batch = {"tokens": _tokens(256, (4, 17), 0)}
    p1, o1, m1 = step(params, opt_state_template(cfg, CPU, opt, tset)(params), batch)
    assert float(m1["skipped"]) == 0.0 and int(o1["step"]) == 1
    layout = flat_layout_for(cfg)
    bad = {**p1, "embed": p1["embed"].clone()}
    bad["embed"][0, 0] = float("inf")
    before = {k: flatten(layout, v).clone() if isinstance(v, dict) else v.clone()
              for k, v in o1.items()}
    p2, o2, m2 = step(bad, o1, batch)
    assert float(m2["skipped"]) == 1.0
    assert int(o2["step"]) == 1               # Adam bias step frozen
    for (_, a), (_, b) in zip(tree_leaves(bad), tree_leaves(p2)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for k in ("m", "v"):
        got = flatten(layout, o2[k]) if isinstance(o2[k], dict) else o2[k]
        assert torch.equal(got.view(torch.int32), before[k].view(torch.int32)), k


@pytest.mark.parametrize("mode", ["faithful", "zero"])
def test_resume_matches_uninterrupted_run(tmp_path, mode):
    cfg = _tcfg()
    shape = ShapeConfig("t", "train", 16, 8)
    opt = OptConfig(kind="adam", lr=1e-2, bucket_mb=0.05)
    tset = _port_settings(mode, 1)
    ref = train(cfg, shape, CPU, opt, tset, LoopConfig(steps=6, ckpt_every=0, log_every=0))
    train(cfg, shape, CPU, opt, tset,
          LoopConfig(steps=3, ckpt_every=3, ckpt_dir=str(tmp_path), log_every=0))
    res = train(cfg, shape, CPU, opt, tset,
                LoopConfig(steps=6, ckpt_every=6, ckpt_dir=str(tmp_path), log_every=0))
    assert res["final_loss"] == ref["final_loss"]
    for (_, a), (_, b) in zip(tree_leaves(res["params"]), tree_leaves(ref["params"])):
        assert torch.equal(a, b)
    assert int(res["opt_state"]["step"]) == 6
