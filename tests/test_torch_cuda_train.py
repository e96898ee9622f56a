"""The training slice's kernels on the card: ``flat_adam`` against its plain
version, the flash gradient against autograd through ``attention_ref``,
and one faithful train step through both kernels against the same step's
plain versions on the CPU.

Every case is ``cuda``-marked and skips without a card.  The module
imports nothing of JAX, so on the card it runs as
``python -m pytest -m cuda --noconftest tests/test_torch_cuda_train.py``.

Tolerances: ``flat_adam`` 1e-6 absolute and relative (the same fp32
formula; ``powf``, ``sqrtf``, division and FMA contraction differ by an ulp
or two).  Flash gradient, fp32: 1e-5 + 1e-4 relative (the same sums in
another order); bf16: 2% of the tensor's largest entry plus 1% — the
recompute casts each 128-row chunk of k and v to fp32 on its own, so dk
and dv arrive as bf16-rounded partial sums added in bf16.  Train step,
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
