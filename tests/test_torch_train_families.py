"""The port's trainer on every family the reference trains, against the
reference's ``build_train_step``: ``zamba2-1.2b`` (hybrid: the SSD scan
under a gradient), ``qwen3-moe-30b-a3b`` (moe: the load-balance term),
``xlstm-1.3b`` (ssm), ``whisper-tiny`` (audio: ``frames``) and
``internvl2-76b`` (vlm: ``patch_embeds``), at smoke width in fp32.

Both packages start from the JAX family's ``init`` (converted through
numpy) and take the same numpy tokens and frontend extras, for three Adam
steps at lr 1e-3, with and without §5.1 slicing (2 slices).  Each runs the
program the reference engages on ``single_device_mesh()``: the faithful
flat program for every family but MoE, which the reference (and the
port) trains on the per-parameter path.  The port runs
``attn_impl="kernel"``: on CPU tensors the kernel wrappers run their plain
versions, and the SSD scan's autograd Function its recompute backward.

Each of the three steps is held against the reference's step taken from
the port's own parameters and optimizer state of that step: loss within
1e-5 relative, grad norm 1e-4, and the updated parameters ``3 lr`` with
at most 0.1% of elements beyond 5e-5, ``test_torch_train_step.py``'s
tolerances for the same reason (the same fp32 arithmetic in another
reduction order; Adam moves an element whose gradient is near zero
anywhere in [-lr, lr]).  Two free-running trajectories are not compared
past the first step: at smoke width with random weights they part by
more than the arithmetic does.  Measured: the few elements Adam moves
~1e-3 apart at step 1 (5 of zamba's in_proj) move zamba's step-2
gradient norm 0.16% (the reference gives 145.94 from its own parameters,
146.19 from the port's; the port 146.18) and its step-3 loss 8e-5
relative.  MoE's ``lb_loss`` is held to 1e-5 relative and ``drop_frac``
exactly (a count over ``T k``).  A routing choice that differs between
the two frameworks would move every later number: on a mismatch the
message reports the smallest gap, over the step's tokens and layers,
between a row's k-th and (k+1)-th router logits in the port.

Also here, the ``ssd`` wrapper's gradients against ``jax.vjp`` of the
reference's ``ssd_chunked``, and the launcher (``launch.train.main``) in
process for every id of ``ARCH_IDS``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.mesh import single_device_mesh
from repro.models import registry as jreg
from repro.models.common import ShardRules
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro.optim import OptConfig as JOptConfig
from repro.train.step import TrainSettings as JTrainSettings
from repro.train.step import build_train_step as j_build_train_step
from repro.train.step import opt_state_template as j_opt_state_template
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import single_device_group
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import OptConfig
from repro_torch.optim.flat import tree_leaves
from repro_torch.train import TrainSettings, build_train_step
from repro_torch.train.step import opt_state_template
from test_torch_train_step import LR, assert_params_close

FAMILIES = ["zamba2-1.2b", "qwen3-moe-30b-a3b", "xlstm-1.3b", "whisper-tiny",
            "internvl2-76b"]
# the other three families' parity cases are test_torch_train_xlstm_frontends.py's
# (a file of its own, so that each file's run stays short)
HERE = FAMILIES[:2]
CPU = single_device_group("cpu")
B, S = 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: smoke-width ops are too small to split, and
    beside the suite's other workers more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                               attn_impl="kernel")
    return jcfg, tcfg


def _batch(cfg, seed):
    """Tokens (B, S_text + 1) and the family's frontend extra, fp32 numpy."""
    rng = np.random.default_rng(seed)
    s_text = S - (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, s_text + 1)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim), dtype=np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    return b


def _routing_gap(tcfg, tparams, batch) -> float:
    """The smallest gap between a row's k-th and (k+1)-th router logits over
    every MoE layer of the port's forward on ``batch``."""
    gaps = []
    route = tmoe.route

    def spy(xt, router_w, k):
        logits, w, ids = route(xt, router_w, k)
        top = torch.sort(logits, dim=-1, descending=True).values
        gaps.append(float((top[:, k - 1] - top[:, k]).min()))
        return logits, w, ids

    tmoe.route = spy
    try:
        with torch.no_grad():
            treg.get_module(tcfg).loss_fn(tcfg, tparams, batch, remat=False)
    finally:
        tmoe.route = route
    return min(gaps)


def check_family(arch, k):
    jcfg, tcfg = _cfgs(arch)
    moe = tcfg.family == "moe"
    mesh = single_device_mesh()
    rules = ShardRules.for_mesh(mesh, faithful=not moe)
    jset = JTrainSettings(num_slices=k, faithful=not moe)
    tset = TrainSettings(num_slices=k, faithful=not moe)
    jopt = JOptConfig(kind="adam", lr=LR, bucket_mb=0.05)
    topt = OptConfig(kind="adam", lr=LR, bucket_mb=0.05)
    jstep = jax.jit(j_build_train_step(jcfg, mesh, rules, jopt, jset))
    jinit, _ = j_opt_state_template(jcfg, mesh, rules, jopt, jset)
    tstep = build_train_step(tcfg, CPU, topt, tset)
    assert tstep._flat_engine == (None if moe else "faithful")

    jp = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0))
    jo0 = jinit(jp)
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    to = opt_state_template(tcfg, CPU, topt, tset)(tp)

    def to_jax(like, tree):
        return jax.tree.unflatten(jax.tree.structure(like),
                                  [jnp.asarray(t.numpy()) for _, t in tree_leaves(tree)])

    for i in range(3):
        batch = _batch(tcfg, 10 + i)
        tbatch = {n: torch.as_tensor(v) for n, v in batch.items()}
        gap = _routing_gap(tcfg, tp, tbatch) if moe else None
        jp, jo, jm = jstep(to_jax(jp, tp), to_jax(jo0, to),
                           {n: jnp.asarray(v) for n, v in batch.items()})
        tp, to, tm = tstep(tp, to, tbatch)
        where = f"{arch} k={k} step {i + 1}" + (f", routing gap {gap:.3g}" if moe else "")
        assert np.isfinite(float(tm["loss"])) and np.isfinite(float(tm["grad_norm"])), where
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5,
                                   err_msg=where)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4, err_msg=where)
        if moe:
            np.testing.assert_allclose(float(tm["lb_loss"]), float(jm["lb_loss"]),
                                       rtol=1e-5, err_msg=where)
            assert float(tm["drop_frac"]) == float(jm["drop_frac"]), where
            assert 0.0 <= float(tm["drop_frac"]) <= 1.0
        else:
            assert float(tm["skipped"]) == float(jm["skipped"]) == 0.0, where
        assert int(to["step"]) == int(jo["step"]) == i + 1
        for a, (path, b) in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            assert_params_close(b.numpy(), a, f"{where}: {'/'.join(path)}")


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("arch", HERE)
def test_train_step_matches_jax(arch, k):
    check_family(arch, k)


# ---------------------------------------------------------------------------
# The SSD scan's gradient
# ---------------------------------------------------------------------------


def _ssd_inputs(Bz=2, T=37, H=4, G=2, N=8, P=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bz, T, H, P), dtype=np.float32),
            (0.5 * rng.random((Bz, T, H)) + 0.05).astype(np.float32),
            -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32),
            rng.standard_normal((Bz, T, G, N), dtype=np.float32) / np.float32(N ** 0.5),
            rng.standard_normal((Bz, T, G, N), dtype=np.float32) / np.float32(N ** 0.5))


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_gradients_match_jax_vjp(with_state):
    """The port's ``ssd`` gradients for x, dt, A, B and C against ``jax.vjp``
    of the reference's ``ssd_chunked``, fp32, within 1e-5 of each
    gradient's largest entry (the same arithmetic in another order).  With
    ``with_state`` the final state's cotangent is given too; without it the
    backward takes None for it, as a training step does."""
    args = _ssd_inputs()
    rng = np.random.default_rng(1)
    dy = rng.standard_normal(args[0].shape, dtype=np.float32)
    ds = rng.standard_normal((2, 4, 8, 16), dtype=np.float32)
    chunk = 8

    def jf(*a):
        return j_ssd_chunked(*a, chunk=chunk, return_state=True)

    _, vjp = jax.vjp(jf, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds) if with_state else jnp.zeros(ds.shape)))

    xs = [torch.tensor(a, requires_grad=True) for a in args]
    y, state = ssd_ops.ssd(*xs, chunk=chunk)
    assert y.grad_fn is not None and state.grad_fn is not None
    outs, cots = [y], [torch.tensor(dy)]
    if with_state:
        outs, cots = [y, state], [torch.tensor(dy), torch.tensor(ds)]
    got = torch.autograd.grad(outs, xs, cots)
    for name, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-5, (name, err)


def test_ssd_serving_path_has_no_autograd():
    """With grad off, or no input that requires it, the wrapper returns
    plain tensors (no autograd node)."""
    xs = [torch.tensor(a) for a in _ssd_inputs()]
    y, state = ssd_ops.ssd(*xs, chunk=8)
    assert y.grad_fn is None and state.grad_fn is None
    with torch.no_grad():
        y, _ = ssd_ops.ssd(xs[0].requires_grad_(), *xs[1:], chunk=8)
    assert y.grad_fn is None


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("program", ["faithful", "zero"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launcher_trains_each_family(arch, program):
    """``launch.train.main`` in process at smoke size on the CPU, for every
    id of ``ARCH_IDS``: the faithful or the ZeRO flat program wherever the
    reference engages it, and for MoE the per-parameter path (``--faithful``
    falls back to it; an explicit ``--flat-engine zero`` raises, as the
    reference's does)."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--slices", "2",
            "--ckpt-every", "0"]
    argv += ["--faithful"] if program == "faithful" else ["--flat-engine", "zero"]
    if program == "zero" and get_smoke_config(arch).family == "moe":
        with pytest.raises(ValueError, match="per-parameter path"):
            launch_train.main(argv)
        return
    res = launch_train.main(argv)
    assert np.isfinite(res["final_loss"])
    assert res["skipped_steps"] == 0
