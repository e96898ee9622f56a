"""The port's optimizer layer (``repro_torch.optim``, ``kernels/flat_adam``)
against the JAX reference.

Layouts, bucket partitions and the host-side scatter/unscatter/reshard
are data movement and must equal the reference exactly (leaf order is
``jax.tree.flatten``'s sorted-key order).  Update rules run the same fp32
formulas in both frameworks: 1e-6 absolute on O(1) parameters covers the
last-bit differences of ``pow``/``sqrt``/division between them.  The
``flat_adam`` CUDA kernel is held against its plain version on the card by
``tests/test_torch_cuda_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.flat_adam.ref import flat_adam_ref as j_flat_adam_ref
from repro.models import registry as jreg
from repro.optim import buckets as jb
from repro.optim import flat as jflat
from repro.optim import rules as jrules
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flat_adam.ops import flat_adam
from repro_torch.kernels.flat_adam.ref import flat_adam_ref
from repro_torch.launch.mesh import single_device_group
from repro_torch.models import registry as treg
from repro_torch.optim import buckets as tb
from repro_torch.optim import flat as tflat
from repro_torch.optim import rules as trules

ADAM_KW = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8)


def _np_tree(seed, depth=2):
    """A random nested dict of fp32 arrays with unsorted insertion order."""
    rng = np.random.default_rng(seed)
    names = ["zeta", "alpha", "mid", "b", "a"]
    rng.shuffle(names)
    out = {}
    for name in names[: rng.integers(2, 5)]:
        if depth and rng.random() < 0.4:
            out[name] = _np_tree(seed * 7 + len(name), depth - 1)
        else:
            shape = tuple(int(s) for s in rng.integers(1, 9, rng.integers(0, 4)))
            out[name] = rng.normal(size=shape).astype(np.float32)
    return out


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _jax_paths(tree):
    return [tuple(p.key for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_layout_equal(jl, tl, jtree):
    assert tl.offsets == jl.offsets and tl.sizes == jl.sizes
    assert tl.total == jl.total and tl.shapes == jl.shapes
    assert list(tl.paths) == _jax_paths(jtree)


@pytest.mark.parametrize("seed", range(6))
def test_make_layout_matches_jax_random_trees(seed):
    tree = _np_tree(seed)
    for align in (1, 512):
        _assert_layout_equal(jflat.make_layout(tree, align),
                             tflat.make_layout(_torch_tree(tree), align), tree)


def test_make_layout_matches_jax_smoke_config():
    jp = jreg.abstract_params(jax_smoke("smollm-360m"))
    tl = tflat.make_layout(treg.abstract_params(get_smoke_config("smollm-360m")))
    _assert_layout_equal(jflat.make_layout(jp), tl, jp)


def test_flatten_unflatten_roundtrip_and_zero_copy():
    tree = _torch_tree(_np_tree(3))
    layout = tflat.make_layout(tree)
    buf = tflat.flatten(layout, tree)
    jbuf = jflat.flatten(jflat.make_layout(_np_tree(3)), _np_tree(3))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    views = tflat.unflatten(layout, buf)
    # a tree of views of one buffer flattens to that buffer, no copy
    assert tflat.flatten(layout, views) is buf
    for (_, a), (_, b) in zip(tflat.tree_leaves(tree), tflat.tree_leaves(views)):
        assert torch.equal(a, b)
    # any other tree is copied
    assert tflat.flatten(layout, tree).data_ptr() != buf.data_ptr()


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_make_buckets_matches_jax(n_shards):
    jp = jreg.abstract_params(jax_smoke("smollm-360m"))
    jl = jflat.make_layout(jp)
    tl = tflat.make_layout(treg.abstract_params(get_smoke_config("smollm-360m")))
    for bb in (64, 1024, 20_000, 1 << 30):
        assert dataclasses.astuple(tb.make_buckets(tl, bucket_bytes=bb, n_shards=n_shards)) \
            == dataclasses.astuple(jb.make_buckets(jl, bucket_bytes=bb, n_shards=n_shards))


def test_resolve_bucket_bytes():
    for mb in (4.0, 0.05, 1):
        assert tb.resolve_bucket_bytes(mb) == jb.resolve_bucket_bytes(mb)
    # the reference's branch for a roofline without interconnect numbers
    assert tb.resolve_bucket_bytes("auto", group_size=8) == tb.DEFAULT_BUCKET_BYTES == 4 << 20


def _adam_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 0.05, n).astype(np.float32)
    g = rng.normal(0, 1e-2, n).astype(np.float32)
    m = rng.normal(0, 1e-3, n).astype(np.float32)
    v = rng.uniform(0, 1e-4, n).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("n", [512, 4099])
@pytest.mark.parametrize("t", [1, 1000])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_plain_flat_adam_matches_jax(n, t, wd):
    arrs = _adam_inputs(n, seed=n + t)
    want = j_flat_adam_ref(*(jnp.asarray(a) for a in arrs), jnp.array([t], jnp.int32),
                           weight_decay=wd, **ADAM_KW)
    step = torch.tensor([t], dtype=torch.int32)
    for fn in (flat_adam_ref, flat_adam):     # the wrapper runs ref on a CPU tensor
        got = fn(*(torch.tensor(a) for a in arrs), step, weight_decay=wd, **ADAM_KW)
        for a, b in zip(want, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)


def test_flat_adam_apply_uses_wrapper_and_plain_path():
    arrs = [torch.tensor(a) for a in _adam_inputs(1024, seed=5)]
    step = torch.tensor(3, dtype=torch.int32)
    want = flat_adam_ref(*arrs, step, weight_decay=0.1, **ADAM_KW)
    for use_kernel in (None, False):
        got = tb.flat_adam_apply(*arrs, step, weight_decay=0.1, use_kernel=use_kernel,
                                 **ADAM_KW)
        for a, b in zip(want, got):
            assert torch.equal(a, b)


def test_flat_adam_wrapper_rejects_bad_inputs():
    p = torch.zeros(8)
    step = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        flat_adam(p, torch.zeros(9), p, p, step, lr=1e-3)
    with pytest.raises(TypeError, match="float32"):
        flat_adam(p, p.double(), p, p, step, lr=1e-3)
    with pytest.raises(ValueError, match="step"):
        flat_adam(p, p, p, p, step.long(), lr=1e-3)


def _param_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": rng.normal(size=(3, 8, 4)).astype(np.float32),
                       "b": rng.normal(size=(3, 4)).astype(np.float32)},
            "embed": rng.normal(size=(16, 8)).astype(np.float32),
            "ln": rng.normal(size=(8,)).astype(np.float32)}


@pytest.mark.parametrize("kind,chunked", [("sgd", False), ("momentum", False),
                                          ("rmsprop", False), ("adam", False),
                                          ("adamw", False), ("adam", True),
                                          ("adamw", True)])
def test_apply_update_matches_jax(kind, chunked):
    params = _param_tree(0)
    jopt = jrules.OptConfig(kind=kind, lr=1e-2, weight_decay=0.1, grad_clip=0.5,
                            chunked=chunked)
    topt = trules.OptConfig(kind=kind, lr=1e-2, weight_decay=0.1, grad_clip=0.5,
                            chunked=chunked)
    jp, tp = jax.tree.map(jnp.asarray, params), _torch_tree(params)
    jst, tst = jrules.init_state(jopt, jp), trules.init_state(topt, tp)
    for i in range(3):
        grads = _param_tree(10 + i)
        jp, jst, jm = jrules.apply_update(jopt, jp, jax.tree.map(jnp.asarray, grads), jst)
        tp, tst, tm = trules.apply_update(topt, tp, _torch_tree(grads), tst)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == 3
    for group_j, group_t in ((jp, tp), *((jst[k], tst[k]) for k in ("m", "v") if k in jst)):
        for a, (_, b) in zip(jax.tree.leaves(group_j), tflat.tree_leaves(group_t)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)


def test_optconfig_validation_matches_jax():
    for bad in (dict(kind="lion"), dict(bucket_mb="big"), dict(bucket_mb=0)):
        with pytest.raises(ValueError):
            jrules.OptConfig(**bad)
        with pytest.raises(ValueError):
            trules.OptConfig(**bad)
    assert trules.OptConfig() .__dict__ == jrules.OptConfig().__dict__


@pytest.mark.parametrize("n_shards,bb", [(2, 64), (8, 1024), (3, 20_000)])
def test_scatter_unscatter_reshard_match_jax_bitwise(n_shards, bb):
    jl = jflat.make_layout(jreg.abstract_params(jax_smoke("smollm-360m")))
    tl = tflat.make_layout(treg.abstract_params(get_smoke_config("smollm-360m")))
    old_t = tb.make_buckets(tl, bucket_bytes=bb, n_shards=n_shards)
    old_j = jb.make_buckets(jl, bucket_bytes=bb, n_shards=n_shards)
    new_t = tb.make_buckets(tl, bucket_bytes=4096, n_shards=2)
    new_j = jb.make_buckets(jl, bucket_bytes=4096, n_shards=2)
    rng = np.random.default_rng(n_shards)
    flat = rng.normal(size=tl.total).astype(np.float32)
    sc = tb.rescatter_flat(flat, old_t)
    np.testing.assert_array_equal(sc, jb.rescatter_flat(flat, old_j))
    np.testing.assert_array_equal(tb.unscatter_flat(sc, old_t), flat)
    np.testing.assert_array_equal(tb.unscatter_flat(sc, old_t), jb.unscatter_flat(sc, old_j))
    np.testing.assert_array_equal(tb.reshard_scattered(sc, old_t, new_t),
                                  jb.reshard_scattered(sc, old_j, new_j))
    # each worker's piece of the scattered buffer is scatter_flat's
    buf = torch.tensor(flat)
    for w in range(n_shards):
        piece = tb.scatter_flat(buf, old_t, w).numpy()
        np.testing.assert_array_equal(piece, np.asarray(jb.scatter_flat(jnp.asarray(flat),
                                                                        old_j, w)))
        n = old_t.local_total
        np.testing.assert_array_equal(piece, sc[w * n: (w + 1) * n])


def test_collectives_are_identity_without_group():
    group = single_device_group("cpu")
    tl = tflat.make_layout(treg.abstract_params(get_smoke_config("smollm-360m")))
    buckets = tb.make_buckets(tl, bucket_bytes=1024)
    buf = torch.randn(tl.total)
    want = buf.clone()
    assert torch.equal(tb.bucketed_all_reduce(buf, buckets, group), want)
    local = tb.bucketed_reduce_scatter(buf, buckets, group)
    assert torch.equal(local, want)
    assert torch.equal(tb.bucketed_all_gather(local, buckets, group), want)
