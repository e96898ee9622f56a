"""On the card: the kernel path of the xLSTM, whisper and VLM families
against their plain path (``attn_impl="chunked"``), one case per family and
dtype, at smoke depth.

JAX-free (the card's machine has no JAX): run it there with ``PYTHONPATH=src
python -m pytest -m cuda --noconftest tests/test_torch_frontier_cuda.py``.
Without a card every case skips.  Tolerances: logits within 1e-4 (fp32,
TF32 off: the kernels' fp32 sums in another order) or 5e-2 (bf16: a bf16
rounding or two, 2**-8 each, where a kernel rounds its fp32 result once and
the plain path rounds each op) of their largest entry.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config

DTYPES = ["float32", "bfloat16"]
IMPLS = ["kernel", "chunked"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tokens(dev, vocab, shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(0, vocab, shape).astype(np.int32), device=dev)


def _agree(out, dt):
    for a, b in zip(out["kernel"], out["chunked"]):
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all())
        assert (a - b).abs().max() <= TOL[dt] * b.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_xlstm_kernel_path_on_card(cuda, dt):
    """The RMSNorm kernel on every norm of a prefill and two decode steps
    (``(2 L + 1)`` launches each), against the plain norms."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.models import xlstm_lm

    base = dataclasses.replace(get_smoke_config("xlstm-1.3b"), compute_dtype=dt)
    params = xlstm_lm.init(base, seed=0, device=cuda)
    toks = _tokens(cuda, base.vocab, (2, 13))
    out, launches = {}, {}
    for impl in IMPLS:
        cfg = dataclasses.replace(base, attn_impl=impl)
        p = xlstm_lm.cast_for_compute(cfg, params, cuda)
        before = rmsnorm.launches
        cache, lg = xlstm_lm.prefill(cfg, p, toks)
        out[impl] = [lg]
        for tok in ([3, 7], [250, 1]):
            lg, cache = xlstm_lm.decode_step(cfg, p, cache, torch.tensor(tok, device=cuda), 0)
            out[impl].append(lg)
        launches[impl] = rmsnorm.launches - before
    assert launches == {"kernel": 3 * (2 * base.n_layers + 1), "chunked": 0}
    _agree(out, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_whisper_kernel_path_on_card(cuda, dt):
    """Flash (encoder and cross-attention non-causal, the decoder causal)
    and the norm kernels through a prefill and two decode steps, at head
    dim 64 (the kernel's; the smoke config's is 16), 100 frames (a ragged
    key tile): flash ``E + 2 L`` times a prefill."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import whisper

    base = dataclasses.replace(get_smoke_config("whisper-tiny"), compute_dtype=dt,
                               d_model=192, frontend_dim=192, d_ff=384, enc_seq=100)
    params = whisper.init(base, seed=0, device=cuda)
    toks = _tokens(cuda, base.vocab, (2, 9))
    frames = torch.randn(2, base.enc_seq, base.d_model, device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(0))
    out, launches = {}, {}
    for impl in IMPLS:
        cfg = dataclasses.replace(base, attn_impl=impl)
        p = whisper.cast_for_compute(cfg, params, cuda)
        before = flash_attention.launches
        cache, lg = whisper.prefill(cfg, p, toks, frames, max_len=16)
        launches[impl] = flash_attention.launches - before
        out[impl] = [lg]
        for i, tok in enumerate(([3, 7], [250, 1])):
            lg, cache = whisper.decode_step(cfg, p, cache, torch.tensor(tok, device=cuda), 9 + i)
            out[impl].append(lg)
    assert launches == {"kernel": base.enc_layers + 2 * base.n_layers, "chunked": 0}
    _agree(out, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_vlm_kernel_path_on_card(cuda, dt):
    """Flash and the norm kernels through a prefill with image tokens and
    two decode steps, at head dim 128 (InternVL2's): flash once a layer a
    prefill."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import lm

    base = dataclasses.replace(get_smoke_config("internvl2-76b"), compute_dtype=dt, d_head=128)
    params = lm.init(base, seed=0, device=cuda)
    toks = _tokens(cuda, base.vocab, (2, 9))
    img = torch.randn(2, base.frontend_tokens, base.frontend_dim, device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(0))
    n_ctx = base.frontend_tokens + 9
    out, launches = {}, {}
    for impl in IMPLS:
        cfg = dataclasses.replace(base, attn_impl=impl)
        p = lm.cast_for_compute(cfg, params, cuda)
        before = flash_attention.launches
        cache, lg = lm.prefill(cfg, p, toks, img, max_len=n_ctx + 2)
        launches[impl] = flash_attention.launches - before
        out[impl] = [lg]
        for i, tok in enumerate(([3, 7], [250, 1])):
            lg, cache = lm.decode_step(cfg, p, cache, torch.tensor(tok, device=cuda), n_ctx + i)
            out[impl].append(lg)
    assert launches == {"kernel": base.n_layers, "chunked": 0}
    _agree(out, dt)
