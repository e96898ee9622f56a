"""The port's kernels against the JAX reference's jnp oracles.

On this CPU box every kernel wrapper runs its plain PyTorch version (the
wrapper picks it because the tensors lie on the CPU); those are held
against the reference's ``attention_ref``, ``chunked_attention``,
``paged_attention_ref`` and ``rmsnorm/ref.py`` over the sweep of
``tests/test_kernels.py`` — shapes, windows, softcaps, dtypes — with
ragged and nulled tables for the paged kernel.  (The SSD scan's plain
versions are held in ``tests/test_torch_ssm.py``.)  The CUDA kernels themselves are held against the plain
versions by the ``cuda``-marked cases, which skip without a card (run
them on the card with ``python -m pytest -m cuda --noconftest tests/test_torch_kernels.py``;
the JAX cases skip there when JAX is absent).

Tolerances against the jnp oracles are ``tests/test_kernels.py::_tol``:
fp32 3e-5 (the same fp32 arithmetic in another summation order), bf16 2e-2
(outputs rounded once to bf16, whose ulp at O(1) values is 2**-7 to 2**-8).
A kernel against its plain version on the card is held tighter in bf16,
atol 1e-3 plus rtol 1e-2: both compute in fp32 from the same bf16 inputs
and round once, so they differ by at most one bf16 ulp, under 2**-7 of the
value, and a fault in the kernel's bf16 loads or stores shows.  The SSD
scan's fp32 outputs (from fp32 or bf16 inputs) are held at 1e-4 of the
output's largest entry plus 1e-4 of each entry: the same fp32 products,
blocked by 64 positions in the kernel and by the model's chunk in the
plain version, summed in another order over up to 512 steps.
``rmsnorm_add`` is held like ``rmsnorm``: both the kernel and the plain
version normalise the unrounded fp32 sum.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ops import (paged_attention, scratch_shapes,
                                                     split_plan)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add
from repro_torch.kernels.rmsnorm.ref import rmsnorm_add_ref, rmsnorm_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ops import ssd, ssd_fwd, ssd_plan
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from repro_torch.models import attention as tattn

DTYPES = ["float32", "bfloat16"]
FLASH_SHAPES = [(128, 4, 2, 32), (256, 2, 2, 64), (64, 8, 1, 16)]   # S, H, Hk, D
FLASH_KWARGS = [dict(causal=True), dict(causal=False),
                dict(causal=True, window=48), dict(causal=True, softcap=30.0)]
PAGED_KWARGS = [dict(), dict(window=5), dict(softcap=5.0),
                dict(window=7, softcap=30.0)]
RMSNORM_SHAPES = [(64, 96), (256, 128), (8, 512)]                  # rows, D
# the card cases of the redesigned kernels: flash at ragged and tile-edge
# lengths (tiles of 64), paged at split edges for every block size
FLASH_CARD_S = [1, 17, 63, 64, 65, 100, 300, 1024]
PAGED_CARD_KWARGS = [dict(), dict(window=20), dict(window=70, softcap=30.0)]


def _tol(dt):
    return dict(atol=2e-2, rtol=2e-2) if dt == "bfloat16" else dict(atol=3e-5, rtol=3e-5)


def _card_tol(dt):
    return dict(atol=1e-3, rtol=1e-2) if dt == "bfloat16" else dict(atol=3e-5, rtol=3e-5)


@pytest.fixture(scope="module")
def jref():
    """The reference's oracles (JAX); the JAX cases skip where it is absent."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
    from repro.kernels.paged_attention.ref import paged_attention_ref as j_paged_ref
    from repro.kernels.rmsnorm import ref as j_rmsnorm
    from repro.models import attention as jattn
    return types.SimpleNamespace(jnp=jnp, attention_ref=j_attention_ref,
                                 paged_ref=j_paged_ref, attn=jattn, rmsnorm=j_rmsnorm)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _flash_inputs(S, H, Hk, D, seed=None):
    rng = np.random.default_rng(S + H if seed is None else seed)
    return [rng.normal(size=(2, S, h, D)).astype(np.float32) for h in (H, Hk, Hk)]


def _t(x, dt, device="cpu"):
    return torch.tensor(x).to(device=device, dtype=getattr(torch, dt))


def _paged_split_inputs(rep, bs, Hk=2, D=64, seed=0):
    """Lanes whose lengths sit at the split edges of :func:`split_plan`
    (one below, on, one above the first and second split boundaries),
    length 0, a lane filling its table, and a stale lane (table row nulled
    to the sink block 0)."""
    bps, _ = split_plan(1, bs)
    span = bps * bs                                  # positions per split
    nb = 3 * bps + 1
    lengths = np.array([0, span - 1, span, span + 1, 2 * span - 1, 2 * span + 1,
                        nb * bs - 1, 5], np.int32)
    rng = np.random.default_rng(seed + bs + 7 * rep)
    B, NB = lengths.size, lengths.size * nb + 1
    q = rng.normal(size=(B, Hk, rep, D)).astype(np.float32)
    kp, vp = (rng.normal(size=(NB, bs, Hk, D)).astype(np.float32) for _ in range(2))
    tables = np.zeros((B, nb), np.int32)
    free = list(rng.permutation(np.arange(1, NB)))
    for b in range(B - 1):                           # the last lane is stale
        for j in range(int(lengths[b]) // bs + 1):
            tables[b, j] = free.pop()
    return q, kp, vp, lengths, tables


def _paged_inputs(B=8, Hk=2, rep=3, D=16, bs=4, nb=8, seed=0):
    """Ragged lanes (one at length 0, one filling its table) plus one stale
    lane whose table row is nulled (it reads the sink block 0)."""
    rng = np.random.default_rng(seed)
    NB = B * nb + 1
    q = rng.normal(size=(B, Hk, rep, D)).astype(np.float32)
    kp, vp = (rng.normal(size=(NB, bs, Hk, D)).astype(np.float32) for _ in range(2))
    lengths = rng.integers(0, nb * bs, B).astype(np.int32)
    lengths[0], lengths[1] = 0, nb * bs - 1
    tables = np.zeros((B, nb), np.int32)
    free = list(rng.permutation(np.arange(1, NB)))
    for b in range(B - 1):
        for j in range(int(lengths[b]) // bs + 1):
            tables[b, j] = free.pop()
    return q, kp, vp, lengths, tables


# ---------------------------------------------------------------------------
# Plain versions (the wrappers on CPU tensors) against the jnp oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("S,H,Hk,D", FLASH_SHAPES)
@pytest.mark.parametrize("kwargs", FLASH_KWARGS)
def test_flash_plain_matches_attention_ref(jref, dt, S, H, Hk, D, kwargs):
    q, k, v = _flash_inputs(S, H, Hk, D)
    out = flash_attention(_t(q, dt), _t(k, dt), _t(v, dt), **kwargs)
    jt = lambda x: jref.jnp.asarray(x, dt).transpose(0, 2, 1, 3)
    want = jref.attention_ref(jt(q), jt(k), jt(v), **kwargs).transpose(0, 2, 1, 3)
    assert out.dtype == getattr(torch, dt) and out.shape == (2, S, H, D)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               **_tol(dt))


@pytest.mark.parametrize("S,H,Hk,D", FLASH_SHAPES)
@pytest.mark.parametrize("kwargs", FLASH_KWARGS)
def test_chunked_attention_matches_reference(jref, S, H, Hk, D, kwargs):
    """The port's plain prefill path (chunks of 32, so the causal window
    takes the static band) against the reference's naive oracle."""
    q, k, v = _flash_inputs(S, H, Hk, D, seed=7)
    want = np.asarray(jref.attn.reference_attention(
        *(jref.jnp.asarray(x) for x in (q, k, v)), **kwargs))
    out = tattn.chunked_attention(*(torch.tensor(x) for x in (q, k, v)),
                                  q_chunk=32, kv_chunk=32, **kwargs)
    np.testing.assert_allclose(out.numpy(), want, **_tol("float32"))


@pytest.mark.parametrize("S,H,Hk,D", FLASH_SHAPES)
def test_flash_plain_and_chunked_match_reference_chunked(jref, S, H, Hk, D):
    """Against the reference's own ``chunked_attention`` on its band path
    (causal window, q_chunk == kv_chunk): the port's chunked attention and
    the flash wrapper's plain version."""
    q, k, v = _flash_inputs(S, H, Hk, D, seed=8)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    kw = dict(causal=True, window=48)
    want = np.asarray(jref.attn.chunked_attention(
        *(jref.jnp.asarray(x) for x in (q, k, v)), q_chunk=32, kv_chunk=32, **kw))
    out = tattn.chunked_attention(tq, tk, tv, q_chunk=32, kv_chunk=32, **kw)
    np.testing.assert_allclose(out.numpy(), want, **_tol("float32"))
    np.testing.assert_allclose(flash_attention(tq, tk, tv, **kw).numpy(), want,
                               **_tol("float32"))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kwargs", PAGED_KWARGS)
def test_paged_plain_matches_paged_ref(jref, dt, kwargs):
    q, kp, vp, lengths, tables = _paged_inputs()
    out = paged_attention(_t(q, dt), _t(kp, dt), _t(vp, dt),
                          torch.tensor(lengths), torch.tensor(tables), **kwargs)
    j = lambda x: jref.jnp.asarray(x, dt)
    want = jref.paged_ref(j(q), j(kp), j(vp), jref.jnp.asarray(lengths),
                          jref.jnp.asarray(tables), **kwargs)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               **_tol(dt))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("rows,D", RMSNORM_SHAPES)
def test_rmsnorm_plain_matches_reference(jref, dt, rows, D):
    """``rmsnorm`` and ``rmsnorm_add`` (plain on CPU) against the
    reference's ``rmsnorm_ref``/``rmsnorm_add_ref`` over
    ``test_kernels.py::test_rmsnorm_sweep``'s shapes, gamma in x's dtype.
    The reference's ``rmsnorm_add_ref`` returns the normed sum in fp32; the
    port's, like the kernels, in x's dtype."""
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, D)).astype(np.float32)
    r = rng.normal(size=(rows, D)).astype(np.float32)
    g = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    j = lambda a: jref.jnp.asarray(a, dt)
    out = rmsnorm(_t(x, dt), _t(g, dt))
    assert out.dtype == getattr(torch, dt) and out.shape == (rows, D)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(
        jref.rmsnorm.rmsnorm_ref(j(x), j(g)), np.float32), **_tol(dt))
    normed, summed = rmsnorm_add(_t(x, dt), _t(r, dt), _t(g, dt))
    jn, js = jref.rmsnorm.rmsnorm_add_ref(j(x), j(r), j(g))
    assert normed.dtype == summed.dtype == getattr(torch, dt)
    np.testing.assert_allclose(normed.float().numpy(), np.asarray(jn, np.float32), **_tol(dt))
    np.testing.assert_array_equal(summed.float().numpy(), np.asarray(js, np.float32))


def test_rmsnorm_wrappers_reject_bad_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="last dim"):
        rmsnorm(x, torch.zeros(7))
    with pytest.raises(ValueError, match="residual"):
        rmsnorm_add(x, torch.zeros(4, 9), torch.zeros(8))
    with pytest.raises(TypeError):
        rmsnorm(x.double(), torch.zeros(8))
    with pytest.raises(ValueError, match="cuda or cpu"):
        rmsnorm(x.to("meta"), torch.zeros(8, device="meta"))


def test_paged_write_gather_match_reference(jref):
    """Token and chunk writes land where the reference puts them (the
    sink block excluded: its contents depend on write order)."""
    jnp = jref.jnp
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(9, 4, 2, 8)).astype(np.float32)
    tables = np.array([[1, 2, 0], [4, 5, 6], [0, 0, 0]], np.int32)
    lengths = np.array([5, 9, 3], np.int32)
    new = rng.normal(size=(3, 2, 8)).astype(np.float32)
    tp = torch.tensor(pool)
    tattn.paged_write_token(tp, torch.tensor(tables), torch.tensor(lengths),
                            torch.tensor(new))
    jp = jref.attn.paged_write_token(jnp.asarray(pool), jnp.asarray(tables),
                                     jnp.asarray(lengths), jnp.asarray(new))
    np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])
    np.testing.assert_array_equal(
        tattn.paged_gather(tp, torch.tensor(tables)).numpy()[:2],
        np.asarray(jref.attn.paged_gather(jp, jnp.asarray(tables)))[:2])
    pos = np.arange(4) + 2
    vals = rng.normal(size=(4, 2, 8)).astype(np.float32)
    tp = torch.tensor(pool)
    tattn.paged_write_positions(tp, torch.tensor(tables[0]), torch.tensor(pos),
                                torch.tensor(vals), valid=torch.tensor(pos < 5))
    jp = jref.attn.paged_write_positions(jnp.asarray(pool), jnp.asarray(tables[0]),
                                         jnp.asarray(pos), jnp.asarray(vals),
                                         valid=jnp.asarray(pos < 5))
    np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])


def test_paged_ref_equals_slotted_decode_bitwise():
    """Inside the port the paged plain path equals the slotted decode
    bitwise on equal logical inputs — the anchor of layout parity."""
    rng = np.random.default_rng(2)
    B, Hk, rep, D, S, bs = 2, 1, 3, 16, 16, 4
    lengths = torch.tensor([5, 9], dtype=torch.int32)
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    kv = torch.tensor(rng.normal(size=(2, B, S, Hk, D)).astype(np.float32))
    q, kn, vn = (torch.tensor(rng.normal(size=s).astype(np.float32))
                 for s in ((B, Hk, rep, D), (B, Hk, D), (B, Hk, D)))
    want = tattn.decode_attention(q, kv[0].clone(), kv[1].clone(), kn, vn, lengths)
    pools = []
    for lane in kv:
        pool = torch.zeros(9, bs, Hk, D)
        for b in range(B):
            tattn.paged_write_positions(pool, tables[b], torch.arange(S), lane[b])
        pools.append(pool)
    got = tattn.paged_decode_attention(q, pools[0], pools[1], kn, vn, lengths, tables)
    assert torch.equal(got, want)


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, kv, kv)
    with pytest.raises(TypeError):
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    pq = torch.zeros(2, 1, 3, 16)
    pool = torch.zeros(5, 4, 1, 16)
    with pytest.raises(TypeError, match="int32"):
        paged_attention(pq, pool, pool, torch.zeros(2, dtype=torch.int64),
                        torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="batch"):
        paged_attention(pq, pool, pool, torch.zeros(3, dtype=torch.int32),
                        torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="impl"):
        tattn.paged_decode_attention(pq, pool, pool, pq[:, :, 0], pq[:, :, 0],
                                     torch.zeros(2, dtype=torch.int32),
                                     torch.zeros(2, 3, dtype=torch.int32),
                                     impl="pallas")


def test_build_keys_library_on_source_hash(tmp_path):
    """A library is rebuilt when its sources change: its path is keyed on
    their content."""
    srcs = _build.sources()
    assert set(srcs) == {"flash_attention", "flat_adam", "paged_attention", "rmsnorm", "ssd"}
    d = tmp_path / "k" / "csrc"
    d.mkdir(parents=True)
    src = d / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path(src)
    assert _build.library_path(src) == first
    src.write_text("// two\n")
    assert _build.library_path(src) != first
    assert first.parent == _build.BUILD_DIR
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.check(9, "k")
    _build.check(0, "k")


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kwargs", FLASH_KWARGS)
def test_flash_kernel_matches_plain_on_card(cuda, dt, kwargs):
    q, k, v = _flash_inputs(100, 15, 5, 64)          # ragged S, GQA 3:1
    args = [_t(x, dt, cuda) for x in (q, k, v)]
    before = flash_attention.launches
    out = flash_attention(*args, **kwargs)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_ref(*(a.transpose(1, 2) for a in args), **kwargs).transpose(1, 2)
    torch.testing.assert_close(out.float(), want.float(), **_card_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kwargs", PAGED_KWARGS)
def test_paged_kernel_matches_plain_on_card(cuda, dt, kwargs):
    q, kp, vp, lengths, tables = _paged_inputs(Hk=5, D=64, bs=16, nb=16)
    args = [_t(x, dt, cuda) for x in (q, kp, vp)]
    lt, tt = torch.tensor(lengths, device=cuda), torch.tensor(tables, device=cuda)
    before = paged_attention.launches
    out = paged_attention(*args, lt, tt, **kwargs)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_ref(*args, lt, tt, **kwargs)
    torch.testing.assert_close(out.float(), want.float(), **_card_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("rep,bs", [(1, 8), (8, 32), (5, 3)])
def test_paged_kernel_shapes_on_card(cuda, dt, rep, bs):
    """The ends of the query-group and block sizes the kernel takes."""
    q, kp, vp, lengths, tables = _paged_inputs(Hk=2, rep=rep, D=64, bs=bs, nb=12)
    args = [_t(x, dt, cuda) for x in (q, kp, vp)]
    lt, tt = torch.tensor(lengths, device=cuda), torch.tensor(tables, device=cuda)
    out = paged_attention(*args, lt, tt, window=20)
    torch.cuda.synchronize()
    want = paged_attention_ref(*args, lt, tt, window=20)
    torch.testing.assert_close(out.float(), want.float(), **_card_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("gdt", DTYPES)
@pytest.mark.parametrize("rows,D", [(512, 2048), (8, 4096), (3, 100)])
def test_rmsnorm_kernels_match_plain_on_card(cuda, dt, gdt, rows, D):
    """Both RMSNorm kernels at the serving path's row widths (2048, 4096)
    and a ragged one, gamma in either dtype."""
    rng = np.random.default_rng(rows + D)
    x, r = (_t(rng.normal(size=(rows, D)).astype(np.float32) * 3, dt, cuda) for _ in range(2))
    g = _t((rng.normal(size=(D,)) * 0.1).astype(np.float32), gdt, cuda)
    before = (rmsnorm.launches, rmsnorm_add.launches)
    out = rmsnorm(x, g)
    normed, summed = rmsnorm_add(x, r, g)
    torch.cuda.synchronize()
    assert (rmsnorm.launches, rmsnorm_add.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, g).float(), **_card_tol(dt))
    want_n, want_s = rmsnorm_add_ref(x, r, g)
    torch.testing.assert_close(normed.float(), want_n.float(), **_card_tol(dt))
    assert torch.equal(summed, want_s)


def _ssd_card_tol(want):
    return dict(atol=1e-4 * want.float().abs().max().item(), rtol=1e-4)


def _ssd_conv_views(B, T, H, P, G, N, dt, device, seed):
    """x, B and C as views into one (B, T, H*P + 2*G*N) buffer, as the
    Mamba2 block hands them over (not contiguous), plus dt and A."""
    rng = np.random.default_rng(seed)
    buf = _t(rng.normal(size=(B, T, H * P + 2 * G * N)).astype(np.float32), dt, device)
    x, bm, cm = torch.split(buf, [H * P, G * N, G * N], dim=-1)
    d = _t(rng.uniform(0.01, 0.2, size=(B, T, H)).astype(np.float32), "float32", device)
    A = _t(-rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32), "float32", device)
    return (x.reshape(B, T, H, P), d, A, bm.reshape(B, T, G, N), cm.reshape(B, T, G, N))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B,T,H,P,G,N", [
    (1, 512, 64, 64, 1, 64),          # the zamba2-1.2b prefill at bucket 512
    (2, 300, 8, 64, 2, 64),           # ragged T, two groups
    (1, 37, 4, 16, 1, 8),             # T < the internal chunk, small N, P
    (2, 129, 6, 32, 3, 16),
])
def test_ssd_kernel_matches_plain_on_card(cuda, dt, B, T, H, P, G, N):
    """The model layout: y and the final state against ``ssd_chunked``,
    from strided views (no copy)."""
    args = _ssd_conv_views(B, T, H, P, G, N, dt, cuda, seed=T)
    assert not args[0].is_contiguous()
    before = ssd.launches
    y, state = ssd(*args, chunk=256)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    want_y, want_s = ssd_chunked_ref(*args, chunk=256, return_state=True)
    assert y.dtype == state.dtype == torch.float32
    torch.testing.assert_close(y, want_y, **_ssd_card_tol(want_y))
    torch.testing.assert_close(state, want_s, **_ssd_card_tol(want_s))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("T,H,P,G,N,chunk", [(64, 4, 16, 2, 8, 16), (128, 2, 8, 1, 16, 32),
                                             (32, 8, 32, 4, 4, 8)])
def test_ssd_fwd_kernel_matches_plain_on_card(cuda, dt, T, H, P, G, N, chunk):
    """The TPU layout over ``test_kernels.py::test_ssd_sweep``'s shapes: y
    in x's dtype (bf16: one rounding of the fp32 result, card tolerance)."""
    rng = np.random.default_rng(T + H)
    x = _t(rng.normal(size=(2, H, T, P)).astype(np.float32), dt, cuda)
    d = _t(rng.uniform(0.01, 0.2, size=(2, H, T)).astype(np.float32), "float32", cuda)
    A = _t(-rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32), "float32", cuda)
    bm, cm = (_t(rng.normal(size=(2, G, T, N)).astype(np.float32), dt, cuda) for _ in range(2))
    y = ssd_fwd(x, d, A, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    t = lambda a: a.transpose(1, 2)
    want = t(ssd_chunked_ref(t(x), t(d), A, t(bm), t(cm), chunk=chunk))
    assert y.dtype == x.dtype
    tol = _card_tol(dt) if dt == "bfloat16" else _ssd_card_tol(want)
    torch.testing.assert_close(y.float(), want.to(x.dtype).float(), **tol)


# the bf16 SSD kernel's card cases: chunk edges (chunks of 64) up to 32
# chunks, batch, groups, widths, a dt = 0 tail, unaligned rows
SSD_CARD_T = [1, 63, 64, 65, 128, 511, 512, 2048]


def _ssd_check(y, state, args, T=None):
    """y (and the final state) against ``ssd_chunked`` on the first T
    positions of ``args`` (all of them by default)."""
    if T is not None:
        args = [a[:, :T] if a.dim() > 1 else a for a in args]
    want_y, want_s = ssd_chunked_ref(*args, chunk=256, return_state=True)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y[:, :want_y.shape[1]], want_y, **_ssd_card_tol(want_y))
    if state is not None:
        torch.testing.assert_close(state, want_s, **_ssd_card_tol(want_s))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("T", SSD_CARD_T)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_kernel_edges_on_card(cuda, dt, T, B, G):
    """The model layout at chunk edges, from strided views: y and the
    final state, one launch a call."""
    args = _ssd_conv_views(B, T, 4, 64, G, 64, dt, cuda, seed=T + B + G)
    before = ssd.launches
    y, state = ssd(*args, chunk=256)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    _ssd_check(y, state, args)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("N", [8, 16, 64])
@pytest.mark.parametrize("P", [8, 16, 64])
def test_ssd_kernel_widths_on_card(cuda, dt, N, P):
    args = _ssd_conv_views(2, 130, 4, P, 2, N, dt, cuda, seed=N * P)
    y, state = ssd(*args, chunk=256)
    torch.cuda.synchronize()
    _ssd_check(y, state, args)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("T", [1, 37, 300, 511])
def test_ssd_kernel_valid_tail_on_card(cuda, dt, T):
    """A prompt of T padded to bucket 512 with dt = 0 past it (x, B and C
    left random there): the final state equals the exact-length scan's."""
    args = list(_ssd_conv_views(1, 512, 8, 64, 1, 64, dt, cuda, seed=T))
    args[1][:, T:] = 0.0
    y, state = ssd(*args, chunk=256)
    torch.cuda.synchronize()
    _ssd_check(y, state, args, T=T)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("T", SSD_CARD_T)
def test_ssd_fwd_kernel_edges_on_card(cuda, dt, T):
    """The TPU layout at chunk edges: y in x's dtype (bf16 at the card's
    bf16 tolerance, one rounding of the fp32 result)."""
    x, d, A, bm, cm = (a.transpose(1, 2) if a.dim() > 1 else a
                       for a in _ssd_conv_views(2, T, 4, 64, 2, 64, dt, cuda, seed=T))
    y = ssd_fwd(x, d, A, bm, cm)
    torch.cuda.synchronize()
    t = lambda a: a.transpose(1, 2)
    want = t(ssd_chunked_ref(t(x), t(d), A, t(bm), t(cm), chunk=256))
    assert y.dtype == x.dtype
    tol = _card_tol(dt) if dt == "bfloat16" else _ssd_card_tol(want)
    torch.testing.assert_close(y.float(), want.to(x.dtype).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("P,N", [(64, 64), (20, 12)])
def test_ssd_kernel_unaligned_rows_on_card(cuda, dt, P, N):
    """Rows that are not 16-byte aligned (x, B and C one element into
    their buffer) or not a multiple of 8 wide: staged by scalar loads."""
    B, T, H, G = 2, 200, 4, 2
    rng = np.random.default_rng(P + N)
    buf = _t(rng.normal(size=(B, T, 1 + H * P + 2 * G * N)).astype(np.float32), dt, cuda)
    x, bm, cm = torch.split(buf[..., 1:], [H * P, G * N, G * N], dim=-1)
    d = _t(rng.uniform(0.01, 0.2, size=(B, T, H)).astype(np.float32), "float32", cuda)
    A = _t(-rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32), "float32", cuda)
    args = (x.reshape(B, T, H, P), d, A, bm.reshape(B, T, G, N), cm.reshape(B, T, G, N))
    y, state = ssd(*args, chunk=256)
    torch.cuda.synchronize()
    _ssd_check(y, state, args)


# ---------------------------------------------------------------------------
# The redesigned kernels' arithmetic and checks, on the CPU
# ---------------------------------------------------------------------------


def _flash_p_rounding(S, H=15, Hk=5, D=64):
    """The bf16 kernel's P.V arithmetic against the plain version, in
    torch: attention from bf16 inputs with P fed to the product as one bf16
    rounding, or as the kernel's two terms hi = bf16(p), lo = bf16(p - hi).
    Returns (single, split) as each output's error over the card's bf16
    limit, atol 1e-3 + rtol 1e-2 (both outputs rounded to bf16 once, as
    the kernel and the plain version round theirs)."""
    q, k, v = (torch.tensor(x).bfloat16().float() for x in _flash_inputs(S, H, Hk, D))
    rep = H // Hk
    qf = q.transpose(1, 2).reshape(2, Hk, rep, S, D)
    s = torch.einsum("bhrqd,bhkd->bhrqk", qf, k.transpose(1, 2)) * D ** -0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    out = lambda pp: (torch.einsum("bhrqk,bhkd->bhrqd", pp, v.transpose(1, 2)) / l).bfloat16().float()
    want = out(p)
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    lim = 1e-3 + 1e-2 * want.abs()
    return [((out(pp) - want).abs() / lim).max().item() for pp in (hi, hi + lo)]


@pytest.mark.parametrize("S", [17, 100, 300])
def test_flash_p_split_keeps_card_tolerance(S):
    """Why the bf16 kernel multiplies P into V as two bf16 terms: with one
    bf16 rounding of P, outputs where a few keys dominate and their values
    cancel leave the card's bf16 limit (up to ~2x it at these shapes);
    with hi + lo, only the outputs' own bf16 rounding remains."""
    single, split = _flash_p_rounding(S)
    assert single > 1.0, single
    assert split <= 0.75, split


def test_flash_kernel_checks():
    """The CUDA path's own checks, on CPU tensors: head dim 64, contiguous,
    16-byte aligned (``cp.async``), a grid that fits."""
    q = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)
    kv = torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16)
    flash_ops._check_kernel(q, kv, kv)
    with pytest.raises(ValueError, match="head dim"):
        flash_ops._check_kernel(q[..., :32], kv[..., :32], kv[..., :32])
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops._check_kernel(q.transpose(1, 2), kv, kv)
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        flash_ops._check_kernel(shifted, kv, kv)
    with pytest.raises(ValueError, match="grid"):
        big = torch.zeros(65536, 1, 1, 64, dtype=torch.bfloat16)
        flash_ops._check_kernel(big, big, big)


def test_paged_kernel_checks():
    q = torch.zeros(2, 1, 3, 64)
    pool = torch.zeros(5, 16, 1, 64)
    lengths, tables = torch.zeros(2, dtype=torch.int32), torch.zeros(2, 4, dtype=torch.int32)
    paged_ops._check_kernel(q, pool, pool, lengths, tables)
    with pytest.raises(ValueError, match="rep=9"):
        paged_ops._check_kernel(torch.zeros(2, 1, 9, 64), pool, pool, lengths, tables)
    with pytest.raises(ValueError, match="bs=33"):
        big = torch.zeros(5, 33, 1, 64)
        paged_ops._check_kernel(q, big, big, lengths, tables)
    with pytest.raises(ValueError, match="contiguous"):
        paged_ops._check_kernel(q, pool, pool, lengths, tables.t().contiguous().t())
    shifted = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        paged_ops._check_kernel(shifted, pool, pool, lengths, tables)


@pytest.mark.parametrize("nb,bs", [(64, 16), (1, 1), (1, 32), (7, 3), (64, 1), (12, 32),
                                   (100, 5), (21, 3), (22, 3)])
def test_paged_split_plan(nb, bs):
    """``n_split`` and the blocks per split depend on the table's width and
    the block size only; the splits cover the table, each within the
    kernel's 64 positions; the scratch holds one partial per split."""
    bps, n_split = split_plan(nb, bs)
    assert bps == max(1, paged_ops.SPLIT_POSITIONS // bs)
    assert bps * bs <= paged_ops.SPLIT_POSITIONS
    assert (n_split - 1) * bps < nb <= n_split * bps
    shapes = scratch_shapes(8, 5, 3, 64, n_split)
    assert shapes == {"m": (8, 5, n_split, 3), "l": (8, 5, n_split, 3),
                      "acc": (8, 5, n_split, 3, 64)}
    if (nb, bs) == (64, 16):                         # the serving shape: 640 CTAs
        assert (bps, n_split) == (4, 16) and 8 * 5 * n_split == 640


def _split_combine(q, kp, vp, lengths, tables, *, window=0, softcap=0.0):
    """The kernel's two passes in torch: each live split's partial (m, l,
    acc) over its positions, masked positions at weight 0, then the
    log-sum-exp merge of the splits the combine reads (those meeting the
    lane's blocks [lo, hi)), weight 0 for l = 0."""
    B, Hk, rep, D = q.shape
    bs, nb = kp.shape[1], tables.shape[1]
    bps, n_split = split_plan(nb, bs)
    out = torch.zeros_like(q)
    for b in range(B):
        length = int(lengths[b])
        hi = min(length // bs + 1, nb)
        lo = max(int((length - window + 1) / bs), 0) if window > 0 else 0  # C division
        parts = []
        for s in range(lo // bps, (hi - 1) // bps + 1 if hi > lo else lo // bps):
            j0, j1 = max(s * bps, lo), min((s + 1) * bps, hi)
            assert j0 < j1, (b, s)                   # every split read was written
            blk = tables[b, j0:j1].long()
            k = kp[blk].reshape(-1, Hk, D).transpose(0, 1)
            v = vp[blk].reshape(-1, Hk, D).transpose(0, 1)
            pos = torch.arange(j0 * bs, j1 * bs)
            ok = pos <= length
            if window > 0:
                ok &= pos > length - window
            sc = torch.einsum("hrd,hpd->hrp", q[b], k) * D ** -0.5
            if softcap:
                sc = softcap * torch.tanh(sc / softcap)
            sc = torch.where(ok, sc, NEG_INF)
            m = sc.amax(-1)
            p = torch.where(ok, torch.exp(sc - m[..., None]), 0.0)
            parts.append((m, p.sum(-1), torch.einsum("hrp,hpd->hrd", p, v)))
        if not parts:
            continue
        ms = torch.stack([m for m, _, _ in parts])
        ls = torch.stack([l for _, l, _ in parts])
        live = ls > 0
        mg = torch.where(live, ms, NEG_INF).amax(0)
        w = torch.where(live, torch.exp(ms - mg), 0.0)
        acc = sum(wi[..., None] * a for wi, (_, _, a) in zip(w, parts))
        out[b] = acc / (w * ls).sum(0).clamp_min(1e-30)[..., None]
    return out


@pytest.mark.parametrize("bs", [3, 4, 8, 16, 32])
@pytest.mark.parametrize("kwargs", PAGED_CARD_KWARGS)
def test_paged_split_combine_matches_plain(bs, kwargs):
    """The split plan's arithmetic (live splits from the length and the
    window, per-split partials, the merge) against the plain version, in
    fp32 on the CPU, at the split edges the card cases use."""
    q, kp, vp, lengths, tables = (torch.tensor(x) for x in _paged_split_inputs(3, bs))
    want = paged_attention_ref(q, kp, vp, lengths, tables, **kwargs)
    got = _split_combine(q, kp, vp, lengths, tables, **kwargs)
    torch.testing.assert_close(got, want, **_tol("float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("S", FLASH_CARD_S)
@pytest.mark.parametrize("rep", [1, 3, 5])
@pytest.mark.parametrize("kwargs", FLASH_KWARGS)
def test_flash_kernel_edges_on_card(cuda, dt, S, rep, kwargs):
    """Ragged and tile-edge lengths (tiles of 64 rows and keys), batch 2,
    GQA 1:1, 3:1 and 5:1 over 15 q-heads, every mask option."""
    q, k, v = _flash_inputs(S, 15, 15 // rep, 64)
    args = [_t(x, dt, cuda) for x in (q, k, v)]
    out = flash_attention(*args, **kwargs)
    torch.cuda.synchronize()
    want = attention_ref(*(a.transpose(1, 2) for a in args), **kwargs).transpose(1, 2)
    torch.testing.assert_close(out.float(), want.float(), **_card_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("bs", [3, 4, 8, 16, 32])
@pytest.mark.parametrize("rep", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("kwargs", PAGED_CARD_KWARGS)
def test_paged_kernel_split_edges_on_card(cuda, dt, bs, rep, kwargs):
    """Lengths one below, on and one above split boundaries, length 0, a
    full table, a stale lane, and windows that leave whole splits dead."""
    q, kp, vp, lengths, tables = _paged_split_inputs(rep, bs)
    args = [_t(x, dt, cuda) for x in (q, kp, vp)]
    lt, tt = torch.tensor(lengths, device=cuda), torch.tensor(tables, device=cuda)
    before = paged_attention.launches
    out = paged_attention(*args, lt, tt, **kwargs)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_ref(*args, lt, tt, **kwargs)
    torch.testing.assert_close(out.float(), want.float(), **_card_tol(dt))


def _ssd_split_rounding(T, split, H=64, P=64, N=64, Q=64):
    """The bf16 kernel's arithmetic in torch: chunks of 64, the chunk
    states (B_k w_k) x_k^T, the state pass in fp32, C.S_prev and (scores o
    decay o dt_k).x, with the three operands that are not exact in bf16
    entering their products as one bf16 rounding, or (``split``) as the
    kernel's two terms hi = bf16(v), lo = bf16(v - hi); fp32 products of
    the rounded values, as the tensor cores accumulate.  Returns each
    output's (y, state) error against ``ssd_chunked`` over the card's
    limit, 1e-4 of the largest entry plus 1e-4 of each entry."""
    bf = lambda t: t.bfloat16().float()
    rnd = (lambda t: bf(t) + bf(t - bf(t))) if split else bf
    args = _ssd_conv_views(1, T, H, P, 1, N, "bfloat16", "cpu", seed=T)
    want = ssd_chunked_ref(*args, chunk=256, return_state=True)
    x, dt, A, Bm, Cm = args
    nc = -(-T // Q)
    pad = lambda a: torch.nn.functional.pad(a.float(), [0, 0] * (a.dim() - 2) + [0, nc * Q - T])
    xc, Bc, Cc = (pad(a).reshape(1, nc, Q, H, -1) for a in (x, Bm.expand(1, T, H, N),
                                                               Cm.expand(1, T, H, N)))
    dtc = pad(dt).reshape(1, nc, Q, H)
    cum = torch.cumsum(dtc * A, 2)
    seg = cum[:, :, -1]
    w = torch.exp(seg[:, :, None] - cum) * dtc
    states = torch.einsum("bckhn,bckhp->bchnp", rnd(Bc * w[..., None]), xc)
    S, prev = torch.zeros(1, H, N, P), []
    for c in range(nc):
        prev.append(S)
        S = S * torch.exp(seg[:, c])[..., None, None] + states[:, c]
    inter = torch.einsum("bcqhn,bchnp->bcqhp", Cc, rnd(torch.stack(prev, 1)))
    inter = inter * torch.exp(cum)[..., None]
    ct = cum.permute(0, 1, 3, 2)
    mask = torch.ones(Q, Q, dtype=torch.bool).tril()
    diff = torch.where(mask, ct[..., :, None] - ct[..., None, :], 0.0)
    sd = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc) * torch.exp(diff)
    sd = torch.where(mask, sd * dtc.permute(0, 1, 3, 2)[..., None, :], 0.0)
    y = (inter + torch.einsum("bchqk,bckhp->bcqhp", rnd(sd), xc)).reshape(1, nc * Q, H, P)
    return [((g - w).abs() / (1e-4 * w.abs().max() + 1e-4 * w.abs())).max().item()
            for g, w in ((y[:, :T], want[0]), (S, want[1]))]


@pytest.mark.parametrize("T", [37, 300, 512])
def test_ssd_split_keeps_card_tolerance(T):
    """Why the bf16 SSD kernel feeds B_k w_k, the carried state and the
    decayed scores to the tensor cores as two bf16 terms: one rounding of
    them puts y and the state ~10x outside the card's limit at zamba's
    width; hi + lo leaves a few percent of it."""
    single, split = _ssd_split_rounding(T, False), _ssd_split_rounding(T, True)
    assert min(single) > 2.0, single
    assert max(split) <= 0.25, split


@pytest.mark.parametrize("B,T,H,N,P", [(1, 512, 64, 64, 64), (1, 2048, 64, 64, 64),
                                       (1, 1, 64, 64, 64), (3, 65, 4, 8, 16),
                                       (8, 64, 64, 64, 64), (2, 300, 6, 5, 3)])
def test_ssd_plan(B, T, H, N, P):
    """The split from shapes alone: chunks of 64, a chunk-state and a
    chunk-scan block per (chunk, head, batch), four state-pass blocks per
    (head, batch); the scratch holds every chunk's 64 x 64 state (whatever
    N and P) and seg."""
    plan = ssd_plan(B, T, H, N, P)
    nc = -(-T // 64)
    assert plan["n_chunks"] == nc and (nc - 1) * 64 < T <= nc * 64
    assert plan["scratch"] == {"states": (B, H, nc, 64 * 64), "segs": (B, H, nc)}
    assert plan["scratch_floats"] == B * H * nc * (64 * 64 + 1)
    assert plan["blocks"] == {"chunk_state": nc * H * B, "chunk_scan": nc * H * B,
                              "state_pass": 4 * H * B}
    if (B, T) == (1, 512):                       # the timing shape: 512 blocks a pass
        assert plan["blocks"]["chunk_scan"] == 512 >= 132
        assert plan["scratch"]["states"] == (1, 64, 8, 64 * 64)     # 8 MB of fp32


def test_ssd_kernel_checks():
    """The CUDA path's own checks, on CPU tensors."""
    x = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)
    bm = torch.zeros(2, 16, 1, 64, dtype=torch.bfloat16)
    A = torch.zeros(4)
    y = torch.zeros(2, 16, 4, 64)
    ssd_ops._check_kernel(x, A, bm, bm, y, None, seq_axis=1)
    with pytest.raises(ValueError, match="N, P <= 64"):
        big = torch.zeros(2, 16, 1, 65, dtype=torch.bfloat16)
        ssd_ops._check_kernel(x, A, big, big, y, None, seq_axis=1)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops._check_kernel(x, A, bm, bm, y.transpose(2, 3), None, seq_axis=1)
    with pytest.raises(TypeError, match="does not write"):
        ssd_ops._check_kernel(x.float(), A, bm.float(), bm.float(), y.bfloat16(), None,
                              seq_axis=1)
    with pytest.raises(ValueError, match="grid"):
        wide = torch.zeros(1, 2, 65536, 8, dtype=torch.bfloat16)
        ssd_ops._check_kernel(wide, torch.zeros(65536), wide[:, :, :1], wide[:, :, :1],
                              wide.float(), None, seq_axis=1)


# ---------------------------------------------------------------------------
# The RMSNorm kernel's three entries: the gated form, gradients, the plan
# ---------------------------------------------------------------------------

# (leading dims, heads, head_dim): prefill-like (B, T) rows and decode-like
# (B,) rows; 3 x 12 is 36 columns, not a multiple of the kernel's vector
GATED_SHAPES = [((2, 7), 4, 16), ((5,), 3, 12)]
# the card sweep of every entry
RMSNORM_CARD_ROWS = [1, 8, 512, 4096]
RMSNORM_CARD_D = [12, 20, 64, 960, 2048, 4096, 8192]


def _gated_views(lead, H, P, dt, device="cpu", *, seed, y_dt="float32", offset=0):
    """y (fp32 or ``y_dt``, contiguous) and z, x as split views of one
    wider buffer, as the Mamba2 block hands them over (z from ``proj``, x
    from ``conv_out``: row stride 2 * H * P + 8 + offset, inner stride 1;
    ``offset`` 1 starts them off 16-byte alignment), plus gamma and D as
    numpy arrays and the tensors.  Returns (numpy dict, torch dict)."""
    rng = np.random.default_rng(seed)
    D = H * P
    buf = rng.normal(size=lead + (2 * D + 8 + offset,)).astype(np.float32) * 2
    a = dict(y=rng.normal(size=lead + (D,)).astype(np.float32) * 2,
             z=buf[..., offset:offset + D], x=buf[..., offset + D:offset + 2 * D],
             g=(rng.normal(size=(D,)) * 0.1).astype(np.float32),
             d=rng.uniform(0.5, 1.5, size=(H,)).astype(np.float32))
    tb = _t(buf, dt, device)
    t = dict(y=_t(a["y"], y_dt, device), z=tb[..., offset:offset + D],
             x=tb[..., offset + D:offset + 2 * D], g=_t(a["g"], "float32", device),
             d=_t(a["d"], "float32", device))
    return a, t


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("lead,H,P", GATED_SHAPES)
@pytest.mark.parametrize("skip", [True, False])
def test_rmsnorm_gated_matches_reference(dt, lead, H, P, skip):
    """``rmsnorm_gated_ref`` and the wrapper (plain on CPU) against the
    reference's own expression (``models/ssm.py:244-246``): ``y + D x`` in
    fp32, rounded to the compute dtype, then ``rms_norm(y * silu(z))`` with
    ``repro.models.common.rms_norm``; without the skip, ``y`` rounded.  x
    and z are strided split views.  fp32 1e-5 (the same fp32 arithmetic,
    another exp and reduction order); bf16 the rmsnorm cases' 2e-2 (outputs
    rounded once, and the roundings of the intermediates are the same)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models.common import rms_norm as j_rms_norm
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_gated
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_gated_ref

    a, t = _gated_views(lead, H, P, dt, seed=H * P + len(lead))
    assert not t["x"].is_contiguous() and not t["z"].is_contiguous()
    cdt = jnp.dtype(dt)
    jy = jnp.asarray(a["y"])
    if skip:
        jx = jnp.asarray(a["x"], cdt).reshape(lead + (H, P))
        jy = (jy.reshape(lead + (H, P)) + jnp.asarray(a["d"])[:, None]
              * jx.astype(jnp.float32)).reshape(lead + (H * P,))
    jz = jnp.asarray(a["z"], cdt)
    want = np.asarray(j_rms_norm(jy.astype(cdt) * jax.nn.silu(jz), jnp.asarray(a["g"]), 1e-6),
                      np.float32)
    kw = dict(x=t["x"], d_skip=t["d"], head_dim=P) if skip else {}
    tol = dict(atol=1e-5, rtol=1e-5) if dt == "float32" else _tol(dt)
    for got in (rmsnorm_gated_ref(t["y"], t["z"], t["g"], **kw),
                rmsnorm_gated(t["y"], t["z"], t["g"], **kw)):
        assert got.dtype == getattr(torch, dt) and got.shape == t["z"].shape
        np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("name", ["rmsnorm", "rmsnorm_add", "rmsnorm_gated"])
def test_rmsnorm_wrapper_grads_match_plain(name):
    """Through the wrappers' autograd Function (forward: the kernel, or the
    plain version on a CPU tensor; backward: a recompute through the plain
    version) against autograd through the plain version: gradients for
    every input, gamma included, fp32 within 1e-6 (the same plain
    backward).  Without grad mode, or with no input requiring grad, the
    wrapper returns a tensor outside autograd (no Function, no graph)."""
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_gated_ref

    rng = np.random.default_rng(11)
    if name == "rmsnorm_gated":
        _, t = _gated_views((3, 5), 4, 8, "float32", seed=2)
        inputs = [t["y"], t["z"], t["g"], t["x"], t["d"]]
        fn = lambda y, z, g, x, d: ops.rmsnorm_gated(y, z, g, x=x, d_skip=d, head_dim=8)
        ref = lambda y, z, g, x, d: rmsnorm_gated_ref(y, z, g, x, d, 8)
    else:
        buf = _t(rng.normal(size=(3, 5, 40)).astype(np.float32), "float32")
        g = _t((rng.normal(size=(16,)) * 0.1).astype(np.float32), "float32")
        x, r = buf[..., :16], buf[..., 20:36]
        inputs = [x, r, g] if name == "rmsnorm_add" else [x, g]
        fn = getattr(ops, name)
        ref = rmsnorm_add_ref if name == "rmsnorm_add" else rmsnorm_ref
    douts = None
    grads = {}
    for path, f in (("wrapper", fn), ("plain", ref)):
        xs = [x.detach().clone().requires_grad_() for x in inputs]
        outs = f(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        if path == "wrapper":
            assert all(type(o.grad_fn).__name__ == "_NormBackward" for o in outs)
        if douts is None:
            douts = [torch.tensor(rng.normal(size=o.shape).astype(np.float32)) for o in outs]
        grads[path] = torch.autograd.grad(outs, xs, douts)
    assert len(grads["wrapper"]) == len(inputs)
    for a, b in zip(grads["wrapper"], grads["plain"]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    with torch.no_grad():
        outs = fn(*[x.detach().requires_grad_() for x in inputs])
    assert all(o.grad_fn is None for o in (outs if isinstance(outs, tuple) else (outs,)))
    outs = fn(*inputs)
    assert all(o.grad_fn is None for o in (outs if isinstance(outs, tuple) else (outs,)))


def test_rmsnorm_gated_rejects_bad_inputs():
    """The gated wrapper's checks on either device, and the kernel's own
    (``_check_kernel``: inner stride 1, rows at one stride, width) on CPU
    tensors."""
    from repro_torch.kernels.rmsnorm import ops

    y, z, x = torch.zeros(4, 12), torch.zeros(4, 12), torch.zeros(4, 12)
    g, d = torch.zeros(12), torch.zeros(3)
    ops.rmsnorm_gated(y, z, g, x=x, d_skip=d, head_dim=4)
    with pytest.raises(ValueError, match="one value per head"):
        ops.rmsnorm_gated(y, z, g, x=x, d_skip=torch.zeros(4), head_dim=4)
    with pytest.raises(ValueError, match="one value per head"):
        ops.rmsnorm_gated(y, z, g, x=x, d_skip=d, head_dim=5)
    with pytest.raises(ValueError, match="d_skip without x"):
        ops.rmsnorm_gated(y, z, g, d_skip=d, head_dim=4)
    with pytest.raises(ValueError, match="x .* != z"):
        ops.rmsnorm_gated(y, z, g, x=x.bfloat16(), d_skip=d, head_dim=4)
    with pytest.raises(ValueError, match="float32 or"):
        ops.rmsnorm_gated(y.bfloat16(), z, g, x=x, d_skip=d, head_dim=4)
    with pytest.raises(TypeError, match="d_skip"):
        ops.rmsnorm_gated(y, z, g, x=x, d_skip=d.double(), head_dim=4)
    with pytest.raises(TypeError):
        ops.rmsnorm_gated(y, z.double(), g)
    with pytest.raises(ValueError, match="last dim"):
        ops.rmsnorm_gated(y, z, torch.zeros(11))
    # the CUDA kernel's checks
    wide = torch.zeros(4, 30)
    assert ops._check_kernel("k", g, y, wide[:, 2:14], d_skip=d) == [12, 30]
    with pytest.raises(ValueError, match="inner stride 1"):
        ops._check_kernel("k", g, y, wide[:, ::2][:, :12])
    with pytest.raises(ValueError, match="inner stride 1"):
        ops._check_kernel("k", torch.zeros(4), torch.zeros(4, 4).t())
    with pytest.raises(ValueError, match="one stride"):
        ops._check_kernel("k", g, torch.zeros(2, 5, 12)[:, :3])
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_kernel("k", torch.zeros(24)[::2], y)
    with pytest.raises(ValueError, match="at most 8192"):
        ops._check_kernel("k", torch.zeros(8193), torch.zeros(1, 8193))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("D", RMSNORM_CARD_D + [4608, 5, 8191])
def test_rmsnorm_plan(dt, D):
    """The thread mapping the wrappers launch with, from the shape alone:
    every row covered, at most 32 values a thread, powers of two; a decode
    call (8 rows) spreads each row of 2048 or more over a whole block, a
    prefill (512 rows) packs several rows a block, and the grid of a wide
    call has at least one block per SM."""
    from repro_torch.kernels.rmsnorm.ops import MAX_VALUES, THREADS, plan

    vec = 8 if dt == "bfloat16" else 4
    for rows in RMSNORM_CARD_ROWS + [3, 120, 7680]:
        tpr, nv = plan(rows, D, getattr(torch, dt))
        assert tpr & (tpr - 1) == 0 and nv & (nv - 1) == 0 and tpr <= THREADS
        assert tpr * nv * vec >= D and nv * vec <= MAX_VALUES
        rpb = THREADS // tpr
        blocks = -(-rows // rpb)
        if rows == 8 and D >= 2048:
            assert tpr == THREADS
        if rows == 512 and D in (2048, 4096):
            assert rpb >= 2 and blocks >= 132
    with pytest.raises(ValueError, match="D <= 8192"):
        plan(8, 8193, getattr(torch, dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("gdt", DTYPES)
@pytest.mark.parametrize("rows", RMSNORM_CARD_ROWS)
@pytest.mark.parametrize("D", RMSNORM_CARD_D)
def test_rmsnorm_entries_sweep_on_card(cuda, dt, gdt, rows, D):
    """All three entries against their plain versions, x and r (and the
    gated form's x and z) as strided views at a padded row stride, gamma
    (and D) in either dtype; the sum of ``rmsnorm_add`` bitwise; one
    launch each."""
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_gated_ref

    rng = np.random.default_rng(rows + D)
    buf = _t(rng.normal(size=(rows, 2 * D + 8)).astype(np.float32) * 3, dt, cuda)
    x, r = buf[:, :D], buf[:, D + 8:]
    g = _t((rng.normal(size=(D,)) * 0.1).astype(np.float32), gdt, cuda)
    hd = int(np.gcd(D, 64))
    d = _t(rng.uniform(0.5, 1.5, size=(D // hd,)).astype(np.float32), gdt, cuda)
    y = _t(rng.normal(size=(rows, D)).astype(np.float32), "float32", cuda)
    before = (ops.rmsnorm.launches, ops.rmsnorm_add.launches, ops.rmsnorm_gated.launches)
    out = ops.rmsnorm(x, g)
    normed, summed = ops.rmsnorm_add(x, r, g)
    gated = ops.rmsnorm_gated(y, r, g, x=x, d_skip=d, head_dim=hd)
    torch.cuda.synchronize()
    assert (ops.rmsnorm.launches, ops.rmsnorm_add.launches,
            ops.rmsnorm_gated.launches) == tuple(b + 1 for b in before)
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, g).float(), **_card_tol(dt))
    want_n, want_s = rmsnorm_add_ref(x, r, g)
    torch.testing.assert_close(normed.float(), want_n.float(), **_card_tol(dt))
    assert torch.equal(summed, want_s)
    want_g = rmsnorm_gated_ref(y, r, g, x, d, hd)
    torch.testing.assert_close(gated.float(), want_g.float(), **_card_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("lead,H,P", GATED_SHAPES + [((8,), 64, 64), ((1, 512), 64, 64)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("y_of_z", [False, True])
def test_rmsnorm_gated_views_on_card(cuda, dt, lead, H, P, offset, y_of_z):
    """The gated form on the Mamba2 block's views (zamba2's decode and
    bucket-512 prefill shapes, and narrow ones), rows 16-byte aligned or
    one element off, y fp32 or of z's dtype, with and without the skip;
    then ``rmsnorm`` and ``rmsnorm_add`` on the same unaligned views."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_gated
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_gated_ref

    _, t = _gated_views(lead, H, P, dt, cuda, seed=H + P + offset,
                        y_dt=dt if y_of_z else "float32", offset=offset)
    for kw in (dict(x=t["x"], d_skip=t["d"], head_dim=P), {}):
        got = rmsnorm_gated(t["y"], t["z"], t["g"], **kw)
        torch.cuda.synchronize()
        want = rmsnorm_gated_ref(t["y"], t["z"], t["g"], kw.get("x"), kw.get("d_skip"), P)
        torch.testing.assert_close(got.float(), want.float(), **_card_tol(dt))
    out = rmsnorm(t["z"], t["g"])
    normed, summed = rmsnorm_add(t["z"], t["x"], t["g"])
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), rmsnorm_ref(t["z"], t["g"]).float(), **_card_tol(dt))
    want_n, want_s = rmsnorm_add_ref(t["z"], t["x"], t["g"])
    torch.testing.assert_close(normed.float(), want_n.float(), **_card_tol(dt))
    assert torch.equal(summed, want_s)


@pytest.mark.cuda
def test_rmsnorm_kernels_reject_on_card(cuda):
    """A CUDA tensor the kernel does not take raises: no fallback."""
    x = torch.zeros(4, 8200, device=cuda)
    with pytest.raises(ValueError, match="at most 8192"):
        rmsnorm(x, torch.zeros(8200, device=cuda))
    with pytest.raises(ValueError, match="inner stride 1"):
        rmsnorm(torch.zeros(16, 4, device=cuda).t(), torch.zeros(16, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("tpr,nv", [(1, 1), (128, 1), (3, 4), (512, 1), (256, 8)])
def test_rmsnorm_launcher_refuses_bad_plan(cuda, tpr, nv):
    """The C launcher checks the mapping it is handed: threads per row a
    power of two of at most a block, vectors per thread one the kernel is
    built for, and together covering a bf16 row of 2048 (256 vectors)."""
    from repro_torch.kernels.rmsnorm import ops

    x = torch.zeros(8, 2048, dtype=torch.bfloat16, device=cuda)
    g, out = torch.zeros(2048, device=cuda), torch.empty_like(x)
    rc = ops._entry("rmsnorm_fwd")(x.data_ptr(), 2048, g.data_ptr(), out.data_ptr(), 1, 0,
                                   8, 2048, 1e-6, tpr, nv, ops._stream(x))
    assert rc != 0
    assert ops._entry("rmsnorm_fwd")(x.data_ptr(), 2048, g.data_ptr(), out.data_ptr(), 1, 0,
                                     8, 2048, 1e-6, *ops.plan(8, 2048, x.dtype),
                                     ops._stream(x)) == 0
