"""The training slice's kernels on the card: ``flat_adam`` against its plain
version, the flash gradient against autograd through ``attention_ref``,
the SSD scan's gradient against autograd through ``ssd_chunked_ref``, and
one faithful train step through both kernels against the same step's
plain versions on the CPU, the FSDP step over a one-rank NCCL group
(every weight gathered, every gradient reduce-scattered) against the
replicated rules' step, bitwise, and the ``(1, 1)`` mesh's step (every
model-axis collective over one-rank NCCL subgroups) against the FSDP
step, bitwise.

Every case is ``cuda``-marked and skips without a card.  The module
imports nothing of JAX, so on the card it runs as
``python -m pytest -m cuda --noconftest tests/test_torch_cuda_train.py``.

Tolerances: ``flat_adam`` 1e-6 absolute and relative (the same fp32
formula; ``powf``, ``sqrtf``, division and FMA contraction differ by an ulp
or two).  Flash gradient, fp32: 1e-5 + 1e-4 relative (the same sums in
another order); bf16: 2% of the tensor's largest entry plus 1% — the
recompute casts each 128-row chunk of k and v to fp32 on its own, so dk
and dv arrive as bf16-rounded partial sums added in bf16.  SSD gradient
(the kernel's forward, the plain scan's recompute backward): fp32 1e-4 of
each gradient's largest entry, bf16 2e-2 (x, B and C's gradients are
rounded to bf16).  Train step,
fp32 with TF32 off: loss 1e-5, grad norm 1e-4 relative, parameters within
``3 lr`` with at most 0.1% of elements beyond 5e-5 (Adam's first step
turns last-bit gradient differences near zero into moves of up to ±lr).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flat_adam.ops import flat_adam
from repro_torch.kernels.flat_adam.ref import flat_adam_ref
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from repro_torch.launch.mesh import single_device_group
from repro_torch.models import lm
from repro_torch.models.common import map_tree
from repro_torch.optim import OptConfig
from repro_torch.optim.flat import flatten
from repro_torch.train import TrainSettings, build_train_step, opt_state_template
from repro_torch.train.step import flat_layout_for

ADAM_KW = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flat_adam and flash kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _adam_inputs(n, seed, device):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(0, 0.05, n), rng.normal(0, 1e-2, n), rng.normal(0, 1e-3, n),
            rng.uniform(0, 1e-4, n))
    return [torch.tensor(a.astype(np.float32), device=device) for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 512, 65_537, 1 << 20])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_flat_adam_kernel_matches_plain_on_card(cuda, n, wd):
    arrs = _adam_inputs(n, n, cuda)
    for t in (1, 1000):
        step = torch.tensor([t], dtype=torch.int32, device=cuda)
        before = flat_adam.launches
        got = flat_adam(*arrs, step, weight_decay=wd, **ADAM_KW)
        torch.cuda.synchronize()
        assert flat_adam.launches == before + 1
        want = flat_adam_ref(*arrs, step, weight_decay=wd, **ADAM_KW)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
def test_flat_adam_kernel_unaligned_views_on_card(cuda):
    """Views at an odd offset take the scalar path."""
    arrs = [b[1:] for b in _adam_inputs(4097, 9, cuda)]
    step = torch.tensor([7], dtype=torch.int32, device=cuda)
    got = flat_adam(*arrs, step, **ADAM_KW)
    want = flat_adam_ref(*arrs, step, **ADAM_KW)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_gradient_on_card(cuda, dt):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 256, h, 64, generator=gen, device=cuda).to(getattr(torch, dt))
               for h in (6, 2, 2))
    dout = torch.randn(2, 256, 6, 64, generator=gen, device=cuda).to(q.dtype)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_attention(*xs, causal=True).backward(dout)
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    attention_ref(*(y.transpose(1, 2) for y in ys), causal=True).transpose(1, 2).backward(dout)
    for x, y in zip(xs, ys):
        if dt == "bfloat16":
            atol, rtol = 2e-2 * y.grad.float().abs().max().item(), 1e-2
        else:
            atol, rtol = 1e-5, 1e-4
        torch.testing.assert_close(x.grad, y.grad, atol=atol, rtol=rtol)


def _ssd_leaves(B, T, dt, device, H=64, P=64, G=1, N=64, seed=0):
    """The scan's inputs as the Mamba2 block hands them over: x, B and C
    views into one (B, T, H*P + 2*G*N) leaf, dt and A leaves."""
    rng = np.random.default_rng(seed)
    buf = torch.tensor(rng.normal(size=(B, T, H * P + 2 * G * N)).astype(np.float32),
                       device=device).to(getattr(torch, dt)).requires_grad_()
    d = torch.tensor(rng.uniform(0.01, 0.2, size=(B, T, H)).astype(np.float32),
                     device=device, requires_grad=True)
    A = torch.tensor(-rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32), device=device,
                     requires_grad=True)
    return buf, d, A


def _ssd_args(buf, d, A, H=64, P=64, G=1, N=64):
    B, T = buf.shape[:2]
    x, bm, cm = torch.split(buf, [H * P, G * N, G * N], dim=-1)
    return (x.reshape(B, T, H, P), d, A, bm.reshape(B, T, G, N), cm.reshape(B, T, G, N))


@pytest.mark.cuda
def test_ssd_output_has_grad_fn_on_card(cuda):
    """On a CUDA tensor that requires grad the kernel's outputs carry a
    gradient (the forward launches the kernel once; the backward does
    not launch it)."""
    leaves = _ssd_leaves(1, 128, "bfloat16", cuda)
    before = ssd.launches
    y, state = ssd(*_ssd_args(*leaves), chunk=256)
    assert ssd.launches == before + 1
    assert y.grad_fn is not None and state.grad_fn is not None
    y.sum().backward()
    assert ssd.launches == before + 1
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T", [(1, 512), (2, 1024)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_gradient_on_card(cuda, B, T, dt, with_state):
    """The kernel-backed ``ssd`` under grad against autograd through
    ``ssd_chunked_ref`` at zamba2-1.2b's heads (64 of 64, state 64) and
    chunk (256): y and the final state (the kernel's forward) within 1e-4
    of the largest entry plus 1e-4 of each, and the gradients for x, B, C
    (through their shared leaf), dt and A bitwise, since the backward is the
    plain scan's autograd on the same inputs.  Without ``with_state`` the
    final state gets no gradient, as in training."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(B, T, 64, 64, generator=gen, device=cuda)
    ds = torch.randn(B, 64, 64, 64, generator=gen, device=cuda)
    values, grads = [], []
    for fn in (lambda *a: ssd(*a, chunk=256),
               lambda *a: ssd_chunked_ref(*a, chunk=256, return_state=True)):
        leaves = _ssd_leaves(B, T, dt, cuda)
        y, state = fn(*_ssd_args(*leaves))
        values.append((y.detach(), state.detach()))
        outs, cots = ([y, state], [dy, ds]) if with_state else ([y], [dy])
        grads.append(torch.autograd.grad(outs, leaves, cots))
    for got, want in zip(*values):
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=1e-4)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """One faithful step through both kernels on the card against the same
    step's plain versions on the CPU, fp32 with TF32 off."""
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), compute_dtype="float32",
                              attn_impl="kernel", d_model=192, n_heads=3, n_kv=1)
    assert cfg.head_dim == 64                  # the head dim the kernels compile
    opt = OptConfig(kind="adam", lr=1e-3, bucket_mb=0.05)
    tset = TrainSettings(faithful=True)
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab, (4, 65))
             .astype(np.int32)}
    init = lm.init(cfg, seed=0, device="cpu")
    lr = opt.lr
    out = {}
    for dev in (torch.device("cpu"), cuda):
        group = single_device_group(dev)
        params = map_tree(lambda t: t.to(dev), init)
        before = (flat_adam.launches, flash_attention.launches)
        step = build_train_step(cfg, group, opt, tset)
        p, _, m = step(params, opt_state_template(cfg, group, opt, tset)(params), batch)
        out[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                         flatten(flat_layout_for(cfg), p).cpu())
        on_card = dev.type == "cuda"
        assert flat_adam.launches == before[0] + on_card
        assert flash_attention.launches == before[1] + on_card * 2 * cfg.n_layers
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    diff = (out["cuda"][2] - out["cpu"][2]).abs()
    assert diff.max().item() <= 3 * lr
    assert (diff > 5e-5).float().mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-30b-a3b"])
def test_fsdp_world1_nccl_equals_replicated(cuda, arch):
    """Two steps in 2 slices on a one-rank NCCL group, from the same init:
    the FSDP rules (the gathers and reduce-scatters counted) and the
    replicated rules give the same losses, gradient norms, parameters and
    Adam moments bit for bit, in bf16 compute through the flash and norm
    kernels."""
    import socket

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch_fn
    from repro_torch.launch.mesh import init_group
    from repro_torch.models import common
    from repro_torch.models.common import ShardRules
    from repro_torch.optim.flat import tree_leaves
    from repro_torch.train import init_sharded

    cfg = dataclasses.replace(get_smoke_config(arch), attn_impl="kernel", d_model=192,
                              n_heads=3, n_kv=1, d_head=0)
    assert cfg.head_dim == 64                  # a head dim the flash kernel compiles
    shape = ShapeConfig("t", "train", 64, 4)
    opt = OptConfig(kind="adam", lr=1e-3)
    tset = TrainSettings(num_slices=2)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    group = init_group("nccl", 0, 1, f"tcp://127.0.0.1:{port}", device=cuda)
    try:
        out = {}
        for name, faithful in (("replicated", True), ("fsdp", False)):
            rules = ShardRules.for_group(group, faithful=faithful)
            params, state = init_sharded(cfg, group, opt, 0, tset, rules)
            step = build_train_step(cfg, group, opt, tset, rules)
            common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
            metrics = []
            for i in range(2):
                params, state, m = step(params, state, make_batch_fn(cfg, shape, 0)(i))
                metrics.append({k: float(v) for k, v in m.items()})
            out[name] = (metrics, params, state, dict(common.COUNTS))
        assert out["replicated"][3] == dict.fromkeys(common.COUNTS, 0)
        assert out["fsdp"][3]["all_gather"] > out["fsdp"][3]["reduce_scatter"] > 0
        assert out["fsdp"][0] == out["replicated"][0]
        for i in (1, 2):
            trees = (out["fsdp"][i], out["replicated"][i])
            if i == 2:
                trees = ({k: trees[0][k] for k in ("m", "v")}, {k: trees[1][k] for k in ("m", "v")})
            for (path, a), (_, b) in zip(tree_leaves(trees[0]), tree_leaves(trees[1])):
                assert torch.equal(a, b), path
    finally:
        group.close()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "gemma2-27b", "qwen3-moe-30b-a3b"])
def test_mesh_one_by_one_nccl_equals_fsdp(cuda, arch):
    """Two steps in 2 slices on a ``(data 1, model 1)`` mesh over one-rank
    NCCL subgroups (``ShardRules.for_mesh``: every tensor-, sequence- and
    expert-parallel collective runs, the loss is vocab-parallel) and under
    the FSDP rules on the same card, from the same init: the same losses,
    gradient norms, parameters and Adam moments bit for bit, in bf16
    compute through the flash and norm kernels; the model-axis
    collectives counted."""
    import socket

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch_fn
    from repro_torch.launch.mesh import init_group, mesh_from_group
    from repro_torch.models import common
    from repro_torch.models.common import ShardRules
    from repro_torch.optim.flat import tree_leaves
    from repro_torch.train import init_sharded

    heads, kv = (3, 1) if arch == "smollm-360m" else (4, 2)
    cfg = dataclasses.replace(get_smoke_config(arch), attn_impl="kernel", d_model=64 * heads,
                              n_heads=heads, n_kv=kv, d_head=0)
    assert cfg.head_dim == 64                  # a head dim the flash kernel compiles
    shape = ShapeConfig("t", "train", 64, 4)
    opt = OptConfig(kind="adam", lr=1e-3)
    tset = TrainSettings(num_slices=2)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    group = init_group("nccl", 0, 1, f"tcp://127.0.0.1:{port}", device=cuda)
    try:
        mesh = mesh_from_group(group, (1, 1))
        out = {}
        for name, grp, rules in (("fsdp", group, ShardRules.for_group(group)),
                                 ("mesh", mesh, None)):
            params, state = init_sharded(cfg, grp, opt, 0, tset, rules)
            step = build_train_step(cfg, grp, opt, tset, rules)
            common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
            metrics = []
            for i in range(2):
                params, state, m = step(params, state, make_batch_fn(cfg, shape, 0)(i))
                metrics.append({k: float(v) for k, v in m.items()})
            out[name] = (metrics, params, state, dict(common.COUNTS))
        assert out["fsdp"][3]["model_all_gather"] == 0
        assert out["mesh"][3]["model_all_gather"] > 0 and out["mesh"][3]["vocab_ce"] == 2 * 2 * 2
        assert out["mesh"][0] == out["fsdp"][0]
        for i in (1, 2):
            trees = (out["mesh"][i], out["fsdp"][i])
            if i == 2:
                trees = ({k: trees[0][k] for k in ("m", "v")}, {k: trees[1][k] for k in ("m", "v")})
            for (path, a), (_, b) in zip(tree_leaves(trees[0]), tree_leaves(trees[1])):
                assert torch.equal(a, b), path
    finally:
        group.close()
