"""``repro_torch.core.function`` against the reference's ``repro.core``.

Every case of ``tests/test_core_function_local.py`` runs here twice on the
same numpy inputs: through ``repro.core`` (one JAX CPU device, in
process) and through ``repro_torch.core`` (one worker on the CPU).
Outputs agree within 1e-6 relative in fp32 (the same fp32 arithmetic; a
reduction in another order differs by an ulp or two).  Where a reference
case asserts something only JAX has, the port's case states its torch
counterpart:

* ``test_call_caching``: JAX traces ``fn`` once per signature, so the
  reference counts traces; eager PyTorch runs ``fn`` on every call, so
  the port counts its builds (one cache entry per signature) and calls.
* ``test_device_put_skipped_for_resident_arrays``: a JAX array already
  sharded as the target is the reference's resident input; the port's is
  a tensor already on the worker's device.
* ``test_donate_scattered_inputs``: JAX deletes a donated device buffer;
  the port releases a donated device tensor's storage (and never touches
  a host input, which it stages into a fresh buffer).

Beyond those: the rest of the surface at one worker (``None`` outputs,
``batch=`` into ``SynkData`` and ``DeviceDataset``, ``num_slices``, the
collectives, ``fork``'s refusals) and the paper's Appendix A program (a
small CNN trained by per-worker SGD and an all-reduce) in both packages
from the same numpy weights.  The two-rank cases are in
``test_torch_core_dist.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.core as jsynk
import repro_torch.core as tsynk
from repro.configs import get_smoke_config as jax_smoke
from repro.data import host_corpus as jhost_corpus
from repro_torch.configs import get_smoke_config
from repro_torch.data import host_corpus

RTOL = 1e-6


@pytest.fixture(autouse=True)
def fresh_ctx():
    jsynk.reset()
    tsynk.reset()
    yield
    jsynk.reset()
    tsynk.reset()


def _forks():
    return jsynk.fork(), tsynk.fork(device="cpu")


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=0)


def test_pytree_arguments():
    """Regression: args may be parameter pytrees (paper Appendix A passes
    the network params dict)."""
    _forks()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    params = {"w": rng.normal(size=(4, 2)).astype(np.float32), "b": np.float32(0.5)}
    want = np.mean(x @ params["w"] + params["b"])
    fj = jsynk.function(lambda x, p: jnp.mean(x @ p["w"] + p["b"]),
                        [jsynk.Scatter(), jsynk.Broadcast()], jsynk.Reduce("mean"))
    ft = tsynk.function(lambda x, p: torch.mean(x @ p["w"] + p["b"]),
                        [tsynk.Scatter(), tsynk.Broadcast()], tsynk.Reduce("mean"))
    got_j, got_t = fj(x, params), ft(x, params)
    np.testing.assert_allclose(got_t, want, rtol=1e-5)
    _close(got_t, got_j)


def test_pytree_outputs_prefix_spec():
    cj, ct = _forks()
    n = ct.n_data
    x = np.ones((8 * n, 2), np.float32)
    params = {"w": np.zeros(3, np.float32), "b": np.float32(1.0)}
    fj = jsynk.function(lambda x, p: (jnp.sum(x), jax.tree.map(lambda v: v + 1.0, p)),
                        [jsynk.Scatter(), jsynk.Broadcast()],
                        (jsynk.Reduce("sum"), jsynk.Reduce(None)))
    ft = tsynk.function(lambda x, p: (torch.sum(x), {k: v + 1.0 for k, v in p.items()}),
                        [tsynk.Scatter(), tsynk.Broadcast()],
                        (tsynk.Reduce("sum"), tsynk.Reduce(None)))
    (sj, newj), (st, newt) = fj(x, params), ft(x, params)
    np.testing.assert_allclose(st, 16.0 * n)
    np.testing.assert_allclose(np.asarray(newt["w"]), np.ones((n, 3)))
    _close(st, sj)
    for k in params:
        assert tuple(newt[k].shape) == np.asarray(newj[k]).shape
        _close(newt[k], newj[k])


def test_wrong_arity_raises():
    _forks()
    for synk in (jsynk, tsynk):
        f = synk.function(lambda x: x, [synk.Scatter()], synk.Reduce("mean"))
        with pytest.raises(TypeError, match="takes 1 inputs"):
            f(np.ones(4), np.ones(4))


def test_indivisible_scatter():
    cj, ct = _forks()
    assert ct.n_data == cj.n_data == 1      # 1 worker: everything divides
    fj = jsynk.function(lambda x: jnp.mean(x), [jsynk.Scatter()], jsynk.Reduce("mean"))
    ft = tsynk.function(lambda x: torch.mean(x), [tsynk.Scatter()], tsynk.Reduce("mean"))
    x = np.ones((3, 2), np.float32)
    np.testing.assert_allclose(ft(x), 1.0)
    _close(ft(x), fj(x))


def test_bad_specs_raise():
    for synk in (jsynk, tsynk):
        with pytest.raises(ValueError):
            synk.function(lambda x: x, ["bogus"], synk.Reduce("mean"))
        with pytest.raises(ValueError):
            synk.Reduce("median")
        with pytest.raises(NotImplementedError):
            synk.Scatter(axis=1)


def test_call_caching():
    cj, ct = _forks()
    n = ct.n_data
    traced, ran = [], []

    def fn_j(x):
        traced.append(1)          # JAX: traced once per signature
        return jnp.sum(x)

    def fn_t(x):
        ran.append(1)             # eager: runs on every call
        return torch.sum(x)

    fj = jsynk.function(fn_j, [jsynk.Scatter()], jsynk.Reduce("sum"))
    ft = tsynk.function(fn_t, [tsynk.Scatter()], tsynk.Reduce("sum"))
    for f in (fj, ft):
        f(np.ones((4 * n, 2), np.float32))
        f(np.full((4 * n, 2), 2.0, np.float32))     # same shapes: cached
    n_after_same = len(traced)
    for f in (fj, ft):
        assert f.stats["builds"] == 1 and f.stats["calls"] == 2
        assert f.stats["cache_hits"] == 1
        f(np.ones((8 * n, 2), np.float32))          # new shape: new entry
        assert f.stats["builds"] == 2
    assert len(traced) > n_after_same
    assert len(ran) == 3
    _close(ft(np.ones((8 * n, 2), np.float32)), fj(np.ones((8 * n, 2), np.float32)))


def test_device_put_skipped_for_resident_arrays():
    cj, ct = _forks()
    x = np.ones((4 * ct.n_data, 2), np.float32)
    fj = jsynk.function(lambda x: jnp.sum(x), [jsynk.Scatter()], jsynk.Reduce("sum"))
    ft = tsynk.function(lambda x: torch.sum(x), [tsynk.Scatter()], tsynk.Reduce("sum"))
    fj(x)
    ft(x)
    resident = {"jax": jax.device_put(x, cj.sharding(cj.data_spec(None))),
                "torch": torch.from_numpy(x.copy()).to(ct.device)}
    for f, key in ((fj, "jax"), (ft, "torch")):
        before = f.stats["device_put_skips"]
        np.testing.assert_allclose(np.asarray(f(resident[key])), x.sum())
        assert f.stats["device_put_skips"] == before + 1


def test_donate_scattered_inputs():
    cj, ct = _forks()
    x = np.ones((4 * ct.n_data, 2), np.float32)
    fj = jsynk.function(lambda x: jnp.sum(x), [jsynk.Scatter()], jsynk.Reduce("sum"),
                        donate=True)
    ft = tsynk.function(lambda x: torch.sum(x), [tsynk.Scatter()], tsynk.Reduce("sum"),
                        donate=True)
    for f in (fj, ft):
        np.testing.assert_allclose(np.asarray(f(x)), x.sum())
        np.testing.assert_allclose(np.asarray(f(x + 1)), (x + 1).sum())  # fresh staging
    np.testing.assert_array_equal(x, 1.0)              # a host input is never consumed
    # the torch counterpart of a deleted JAX buffer: the caller's device
    # tensor is consumed (its storage released) ...
    dev = torch.tensor(x)
    np.testing.assert_allclose(ft(dev), x.sum())
    assert dev.untyped_storage().size() == 0
    # ... unless an output shares it
    keep = torch.tensor(x)
    g = tsynk.function(lambda x: x, [tsynk.Scatter()], tsynk.Reduce("concat"), donate=True)
    np.testing.assert_array_equal(g(keep), x)
    assert keep.untyped_storage().size() == x.nbytes


# ---------------------------------------------------------------------------
# The rest of the surface at one worker
# ---------------------------------------------------------------------------


def _pair(fn_j, fn_t, ins, outs):
    spec = lambda synk, s: {"S": synk.Scatter(), "B": synk.Broadcast()}[s]
    return (jsynk.function(fn_j, [spec(jsynk, s) for s in ins], outs),
            tsynk.function(fn_t, [spec(tsynk, s) for s in ins], outs))


@pytest.mark.parametrize("op", ["mean", "sum", "max", "min", "concat", "last", None])
@pytest.mark.parametrize("num_slices", [1, 4])
def test_reduce_ops_and_slices(op, num_slices):
    _forks()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 3)).astype(np.float32)
    w = rng.normal(size=(3,)).astype(np.float32)
    per_row = op in ("concat", None)
    fj, ft = _pair(lambda x, w: x * w if per_row else jnp.sum(x * w, 0),
                   lambda x, w: x * w if per_row else torch.sum(x * w, 0),
                   "SB", op)
    got_j, got_t = fj(x, w, num_slices=num_slices), ft(x, w, num_slices=num_slices)
    assert tuple(got_t.shape) == np.asarray(got_j).shape
    _close(got_t, got_j)


def test_batch_indices_host_and_device():
    cj, ct = _forks()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    idx = rng.permutation(64)[:32]
    fj, ft = _pair(lambda x: jnp.mean(x), lambda x: torch.mean(x), "S", "mean")
    gj, gt = _pair(lambda x: x * 1.0, lambda x: x * 1.0, "S", "concat")
    for src_j, src_t in ((jsynk.data(x), tsynk.data(x)),
                         (jsynk.scatter_data(x), tsynk.scatter_data(x))):
        _close(ft(src_t, batch=idx), fj(src_j, batch=idx))
        np.testing.assert_allclose(ft(src_t, batch=idx), x[idx].mean(), rtol=1e-5)
        np.testing.assert_array_equal(gt(src_t, batch=idx[:7]), x[idx[:7]])
        np.testing.assert_array_equal(np.asarray(gj(src_j, batch=idx[:7])), x[idx[:7]])
    ds = tsynk.scatter_data(x)
    assert (len(ds), ds.local_length, ds.shape) == (64, 64, (64, 4))
    assert ft.stats["device_put_skips"] == 0 and ft.stats["builds"] == 2
    with pytest.raises(IndexError, match="global dataset rows"):
        ft(ds, batch=[64])


def test_fork_and_backends():
    ctx = tsynk.fork(device="cpu")
    assert (ctx.n_data, ctx.n_model, ctx.n_devices, ctx.rank) == (1, 1, 1, 0)
    assert ctx.data_axes == ("data",) and tsynk.current() is ctx
    assert tsynk.fork((1,), ("data",), device="cpu").n_data == 1
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        tsynk.fork((1, 2), ("data", "model"), device="cpu")
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        tsynk.make_mesh((1, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="needs 2 workers"):
        tsynk.fork((2,), ("data",), device="cpu")
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        tsynk.function(lambda x: x, [tsynk.Scatter()], backend="gspmd")
    with pytest.raises(ValueError, match="all four"):
        tsynk.fork(backend="gloo", device="cpu")


def test_collectives_one_worker():
    _forks()
    rng = np.random.default_rng(2)
    w = rng.normal(size=(6,)).astype(np.float32)
    out = {}
    for name, synk in (("jax", jsynk), ("torch", tsynk)):
        p = synk.distribute({"w": w})
        p = synk.set_value(p, 0, {"w": w * 9})
        out[name] = dict(
            avg=synk.get_value(synk.all_reduce(p, "avg"), 0)["w"],
            prod=synk.get_value(synk.all_reduce(p, "prod"), 0)["w"],
            max=synk.get_value(synk.all_reduce(p, "max"), 0)["w"],
            bcast=synk.as_replicated(synk.broadcast(p, root=0))["w"],
            gather=synk.gather(p)["w"],
            reduce_to=synk.reduce_to(p, "sum")["w"],
            shared=synk.get_value(synk.scatter_shared({"d": np.arange(4.0, dtype=np.float32)}),
                                  0)["d"],
            replicated=synk.replicate({"w": w})["w"])
    assert out["torch"]["gather"].shape == (1, 6)
    for k, v in out["jax"].items():
        # prod: the reference takes exp(sum(log)), a NaN for negative
        # entries; the port's ReduceOp.PRODUCT is exact
        want = w * 9 if k == "prod" else np.asarray(v)
        _close(out["torch"][k], want, rtol=1e-5 if k == "prod" else RTOL)


def test_host_corpus_is_synkdata():
    jc = jhost_corpus(jax_smoke("smollm-360m"), 8, 16, seed=3)
    tc = host_corpus(get_smoke_config("smollm-360m"), 8, 16, seed=3)
    assert isinstance(tc, tsynk.SynkData)
    np.testing.assert_array_equal(tc.array, jc.array)


# ---------------------------------------------------------------------------
# Paper Appendix A: a CNN trained by per-worker SGD and all-reduce(avg)
# ---------------------------------------------------------------------------

LR = 0.05


def _cnn_init(seed=0):
    rng = np.random.default_rng(seed)
    return {"conv": (rng.normal(size=(8, 1, 3, 3)) * 0.3).astype(np.float32),
            "w1": (rng.normal(size=(8 * 8 * 8, 64)) * 0.05).astype(np.float32),
            "w2": (rng.normal(size=(64, 10)) * 0.1).astype(np.float32)}


def _jax_program(X, labels, epochs, batch, rng):
    def forward(p, x):
        x = jax.lax.conv_general_dilated(x, p["conv"], (1, 1), "SAME")
        x = jax.nn.relu(x)
        x = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 1, 2, 2), (1, 1, 2, 2),
                                  "VALID")
        return jax.nn.relu(x.reshape(x.shape[0], -1) @ p["w1"]) @ p["w2"]

    def train_fn(x, y, params):
        def loss(p):
            logp = jax.nn.log_softmax(forward(p, x))
            return -jnp.mean(jnp.sum(jax.nn.one_hot(y, 10) * logp, -1))
        l, g = jax.value_and_grad(loss)(params)
        return l, jax.tree.map(lambda p, g: p - LR * g, params, g)

    f = jsynk.function(train_fn, [jsynk.Scatter(), jsynk.Scatter(), jsynk.Broadcast()],
                       (jsynk.Reduce("mean"), jsynk.Reduce(None)))
    return _loop(jsynk, f, X, labels, epochs, batch, lambda new, ctx: new, rng)


def _torch_forward(p, x):
    x = F.max_pool2d(F.relu(F.conv2d(x, p["conv"], padding=1)), 2)
    return F.relu(x.reshape(x.shape[0], -1) @ p["w1"]) @ p["w2"]


def _torch_program(X, labels, epochs, batch, rng):
    def train_fn(x, y, params):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = F.cross_entropy(_torch_forward(p, x), y.long())
        grads = torch.autograd.grad(loss, list(p.values()))
        return loss, {k: v - LR * g for (k, v), g in zip(p.items(), grads)}

    f = tsynk.function(train_fn, [tsynk.Scatter(), tsynk.Scatter(), tsynk.Broadcast()],
                       (tsynk.Reduce("mean"), tsynk.Reduce(None)))
    # Reduce(None) returns the (n_data, ...) stack; this rank keeps its row
    return _loop(tsynk, f, X, labels, epochs, batch,
                 lambda new, ctx: {k: v[ctx.rank] for k, v in new.items()}, rng)


def _loop(synk, train_fn, X, labels, epochs, batch, mine, rng):
    ctx = synk.current()
    X_train, y_train = synk.data(X), synk.data(labels)
    params_local = synk.distribute(_cnn_init())
    losses = []
    for _ in range(epochs):
        order = rng.permutation(len(X_train))
        for i in range(0, len(order), batch):
            host_params = synk.get_value(params_local, 0)
            loss, new = train_fn(X_train, y_train, host_params, batch=order[i:i + batch])
            params_local = synk.all_reduce(synk.LocalValues(mine(new, ctx)), "avg")
            losses.append(float(loss))
    return losses, synk.as_replicated(params_local, check=False)


def _appendix_data(n):
    """The reference example's data: class-shifted noise images (its rng
    then draws the epochs' permutations)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 1, 16, 16)).astype(np.float32)
    labels = rng.integers(0, 10, size=(n,)).astype(np.int32)
    X += labels[:, None, None, None] * 0.6
    return X, labels, rng


def test_appendix_a_program_matches_reference():
    """Both packages, same weights, data and permutations, 3 epochs of 8
    steps.  The same fp32 SGD; conv and matmul sum in another order in
    each framework (measured: losses 6e-7 relative, weights 7e-7 apart).
    Longer runs drift apart: SGD at this learning rate amplifies an ulp
    ~10x an epoch, so the paper-size run is gated on accuracy below."""
    _forks()
    X, labels, rng = _appendix_data(1024)
    lj, pj = _jax_program(X, labels, 3, 128, np.random.default_rng(1))
    lt, pt = _torch_program(X, labels, 3, 128, np.random.default_rng(1))
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    for k in pj:
        np.testing.assert_allclose(np.asarray(pt[k]), np.asarray(pj[k]), rtol=0, atol=1e-5)


def test_appendix_a_program_learns():
    """The example's own size (2048 images, 10 epochs of batch 256): train
    accuracy above 0.4, the reference example's gate."""
    tsynk.fork(device="cpu")
    X, labels, rng = _appendix_data(2048)
    _, params = _torch_program(X, labels, 10, 256, rng)
    with torch.no_grad():
        pred = _torch_forward(params, torch.from_numpy(X[:256])).argmax(-1).numpy()
    assert (pred == labels[:256]).mean() > 0.4
