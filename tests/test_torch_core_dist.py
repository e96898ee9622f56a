"""``repro_torch.core`` across two real workers, against the reference's.

ONE spawn of 2 gloo ranks (``synk.fork(backend="gloo", ...)`` at a free
port on 127.0.0.1) runs every check and writes its results, as
``test_torch_dist.py`` does; ONE spawned process runs the same checks
through ``repro.core`` over 2 JAX CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=2``), the counterpart
of the reference's ``md_checks`` subprocesses.  Both take the same numpy
inputs.  The checks (``src/repro/testing/md_checks.py``):

* ``scatter_reduce`` (:19): the loss, sliced and not, and sum, max, min,
  concat and ``None`` outputs;
* ``indexing`` and ``indexing_global`` (:49, :72): ``batch=`` into host
  data, aligned and routed global ids into a ``DeviceDataset``, padded
  ``concat`` requests cut back to their length;
* ``collectives`` (:200): distribute, set/get value, all-reduce in each
  op, broadcast, ``as_replicated``, ``scatter_shared``, gather, reduce;
* ``sgd_parity`` (:222): Appendix A's SGD with all-reduce(avg) equals the
  serial program.

Tolerances.  Values whose arithmetic is the same on both sides agree
exactly: gathered rows, max, min, concat, last and ``None`` of elementwise
outputs, broadcasts, all-reduces of the same two values.  Sums and means
add in another order per worker (XLA's reduction tree against PyTorch's)
and agree within 1e-6 of the summed magnitudes (relative, for a mean of
squares); the reference's prod (``exp`` of a summed ``log``) within 1e-6
relative of the port's exact product; SGD within 1e-6 relative after 5
steps.
"""
import gc
import multiprocessing
import os
import socket

import numpy as np
import pytest
import torch

WORLD = 2
LR = 0.05


# ---------------------------------------------------------------------------
# The checks, one per backend
# ---------------------------------------------------------------------------


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = rng.normal(size=(64,)).astype(np.float32)
    w = rng.normal(size=(8,)).astype(np.float32)
    rng = np.random.default_rng(1)
    d = rng.normal(size=(64, 4)).astype(np.float32)
    idx = {
        "perm": rng.permutation(64)[:32],
        "aligned": np.concatenate([i * 32 + rng.permutation(32)[:8] for i in range(WORLD)]),
        "repeat": np.asarray([63, 0, 0, 17, 40, 8, 55, 62] * 2),
        "pad13": rng.permutation(64)[:13],
        "pad3": np.asarray([5, 60, 33]),
        "stack": rng.permutation(64)[:8],
    }
    rng = np.random.default_rng(3)
    X = rng.normal(size=(64, 8)).astype(np.float32)
    Y = (X @ rng.normal(size=(8,)) + 0.1).astype(np.float32)
    w0 = rng.normal(size=(8,)).astype(np.float32)
    v = np.random.default_rng(2).normal(size=(6,)).astype(np.float32)
    return dict(x=x, y=y, w=w, d=d, idx=idx, X=X, Y=Y, w0=w0, v=v)


def _checks(synk, xp, grad_fn):
    """The checks through one package: ``xp`` is its array module (jnp or
    torch), ``grad_fn(x, y, w)`` the linear model's gradient in it."""
    inp = _inputs()
    x, y, w, d, idx = inp["x"], inp["y"], inp["w"], inp["d"], inp["idx"]
    S, B = synk.Scatter(), synk.Broadcast()
    out = {}
    np_ = lambda t: np.asarray(t.cpu() if torch.is_tensor(t) else t)

    # scatter_reduce
    f = synk.function(lambda x, y, w: xp.mean((x @ w - y) ** 2), [S, S, B], synk.Reduce("mean"))
    out["loss"] = np_(f(x, y, w))
    out["loss_sliced"] = np_(f(x, y, w, num_slices=4))
    for op in ("sum", "max", "min"):
        out[op] = np_(synk.function(lambda x, op=op: getattr(xp, op)(x), [S], op)(x))
    out["concat"] = np_(synk.function(lambda x: x * 3.0, [S], "concat")(x))
    out["none"] = np_(synk.function(lambda x: x * 3.0, [S], None)(x))
    out["none_sum"] = np_(synk.function(lambda x: xp.sum(x), [S], None)(x))
    out["last"] = np_(synk.function(lambda x: x[0] * 2.0, [S], "last")(x))

    # indexing / indexing_global
    mean = synk.function(lambda x: xp.mean(x), [S], "mean")
    rows = synk.function(lambda x: x * 1.0, [S], "concat")
    stack = synk.function(lambda x: x * 1.0, [S], None)
    out["host_mean"] = np_(mean(synk.data(d), batch=idx["perm"]))
    ds = synk.scatter_data(d)
    for name in ("aligned", "perm", "repeat"):
        out[f"ds_mean_{name}"] = np_(mean(ds, batch=idx[name]))
    for name in ("aligned", "perm", "pad13", "pad3"):
        out[f"ds_rows_{name}"] = np_(rows(ds, batch=idx[name]))
    out["ds_stack"] = np_(stack(ds, batch=idx["stack"]))
    out["host_rows_pad13"] = np_(rows(synk.data(d), batch=idx["pad13"]))

    # collectives
    v = inp["v"]
    p = synk.distribute({"w": v})
    p = synk.set_value(p, 1, {"w": v * 9})
    for op in ("avg", "sum", "max", "min"):
        red = synk.all_reduce(p, op)
        out[f"all_reduce_{op}"] = np.stack([synk.get_value(red, r)["w"] for r in range(WORLD)])
    out["all_reduce_prod_pos"] = synk.get_value(
        synk.all_reduce(synk.LocalValues({"w": xp.abs(p.tree["w"])}), "prod"), 0)["w"]
    bc = synk.broadcast(p, root=1)
    out["broadcast"] = np.stack([synk.get_value(bc, r)["w"] for r in range(WORLD)])
    out["as_replicated"] = np_(synk.as_replicated(bc)["w"])
    try:
        synk.as_replicated(p)
        out["diverged_raises"] = False
    except ValueError:
        out["diverged_raises"] = True
    sc = synk.scatter_shared({"d": np.arange(16.0, dtype=np.float32)})
    out["scatter_shared"] = np.stack([synk.get_value(sc, r)["d"] for r in range(WORLD)])
    out["gather"] = np_(synk.gather(p)["w"])
    out["reduce_to"] = np_(synk.reduce_to(p, "sum", root=1)["w"])

    # sgd_parity: local grads per worker, all-reduce(avg) as the mean
    # output, local update
    f = synk.function(grad_fn, [S, S, B], synk.Reduce("mean"))
    wk = inp["w0"].copy()
    for _ in range(5):
        wk = wk - LR * np_(f(inp["X"], inp["Y"], wk))
    out["sgd"] = wk
    return out


def _torch_grad(x, y, w):
    w = w.detach().requires_grad_()
    return torch.autograd.grad(torch.mean((x @ w - y) ** 2), w)[0]


def _serial_sgd():
    inp = _inputs()
    X, Y, w = (torch.from_numpy(inp[k]) for k in ("X", "Y", "w0"))
    for _ in range(5):
        w = w - LR * _torch_grad(X, Y, w)
    return w.numpy()


def _rank(rank, address, out_dir):
    import repro_torch.core as synk

    torch.set_num_threads(1)
    ctx = synk.fork(backend="gloo", rank=rank, world=WORLD, address=address, device="cpu")
    try:
        assert (ctx.n_data, ctx.rank) == (WORLD, rank)
        torch.save(_checks(synk, torch, _torch_grad), out_dir / f"rank{rank}.pt")
        # both ranks are past their last collective before either tears
        # the group down (rank 0 hosts its store)
        torch.distributed.barrier()
    finally:
        ctx.group.close()
        # drop every reference to the destroyed group (the global context
        # holds one), so its store and gloo threads are freed here, while
        # the interpreter is whole, not during its teardown
        synk.reset()
        del ctx
        gc.collect()


def _reference(out_dir):
    import jax
    import jax.numpy as jnp

    import repro.core as synk

    assert synk.fork().n_data == WORLD
    grad = lambda x, y, w: jax.grad(lambda w: jnp.mean((x @ w - y) ** 2))(w)
    res = _checks(synk, jnp, grad)
    torch.save(res, out_dir / "reference.pt")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Spawn the two ranks and the reference once; returns (ranks, reference)."""
    out_dir = tmp_path_factory.mktemp("core_dist")
    ctx = multiprocessing.get_context("spawn")
    address = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank, args=(r, address, out_dir)) for r in range(WORLD)]
    # the reference's process must see 2 host devices when JAX starts
    old = os.environ.get("XLA_FLAGS")
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    try:
        procs.append(ctx.Process(target=_reference, args=(out_dir,)))
        for p in procs:
            p.start()
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS")
        else:
            os.environ["XLA_FLAGS"] = old
    for p in procs:
        p.join(timeout=240)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a process hung"
    assert [p.exitcode for p in procs] == [0] * (WORLD + 1)
    load = lambda name: torch.load(out_dir / name, weights_only=False)
    return [load(f"rank{r}.pt") for r in range(WORLD)], load("reference.pt")


EXACT = ("max", "min", "concat", "none", "last", "ds_rows_aligned", "ds_rows_perm",
         "ds_rows_pad13", "ds_rows_pad3", "ds_stack", "host_rows_pad13", "all_reduce_avg",
         "all_reduce_sum", "all_reduce_max", "all_reduce_min", "broadcast", "as_replicated", "scatter_shared", "gather", "reduce_to")
SUMMED = ("sum", "none_sum", "loss", "loss_sliced", "host_mean", "ds_mean_aligned",
          "ds_mean_perm", "ds_mean_repeat")


def test_ranks_agree_with_each_other(results):
    ranks, _ = results
    for k, v in ranks[0].items():
        np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)


@pytest.mark.parametrize("key", EXACT)
def test_exact_results_equal_reference(results, key):
    ranks, ref = results
    got, want = np.asarray(ranks[0][key]), np.asarray(ref[key])
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", SUMMED)
def test_summed_results_equal_reference(results, key):
    ranks, ref = results
    inp = _inputs()
    x = inp["x"] if key in ("sum", "none_sum") else None
    scale = np.abs(x).sum() if x is not None else np.abs(np.asarray(ref[key])).max()
    np.testing.assert_allclose(ranks[0][key], ref[key], rtol=0, atol=1e-6 * scale)


def test_prod_equals_reference(results):
    """The reference's prod is ``exp(psum(log))`` (positive inputs here),
    within a few ulps of the port's exact ``ReduceOp.PRODUCT``."""
    ranks, ref = results
    np.testing.assert_allclose(ranks[0]["all_reduce_prod_pos"], ref["all_reduce_prod_pos"],
                               rtol=1e-6)


def test_values_are_the_checks_expectations(results):
    """md_checks' own assertions, on the port's results."""
    ranks, _ = results
    r = ranks[0]
    inp = _inputs()
    x, y, w, d, idx, v = (inp[k] for k in ("x", "y", "w", "d", "idx", "v"))
    np.testing.assert_allclose(r["loss"], np.mean((x @ w - y) ** 2), rtol=1e-5)
    np.testing.assert_allclose(r["loss_sliced"], r["loss"], rtol=1e-5)
    np.testing.assert_allclose(r["sum"], x.sum(), rtol=1e-5)
    assert (r["max"], r["min"]) == (x.max(), x.min())
    np.testing.assert_array_equal(r["concat"], x * 3.0)
    assert r["none"].shape == (WORLD, 32, 8) and r["none_sum"].shape == (WORLD,)
    np.testing.assert_array_equal(r["last"], x[0] * 2.0)
    for name in ("aligned", "perm", "repeat"):
        np.testing.assert_allclose(r[f"ds_mean_{name}"], d[idx[name]].mean(), rtol=1e-5)
    for name in ("aligned", "perm", "pad13", "pad3"):
        np.testing.assert_array_equal(r[f"ds_rows_{name}"], d[idx[name]])
    np.testing.assert_array_equal(r["ds_stack"], d[idx["stack"]].reshape(WORLD, 4, 4))
    np.testing.assert_allclose(r["all_reduce_avg"], np.stack([(v + v * 9) / 2] * WORLD),
                               rtol=1e-6)
    np.testing.assert_array_equal(r["broadcast"], np.stack([v * 9] * WORLD))
    np.testing.assert_array_equal(r["as_replicated"], v * 9)
    assert r["diverged_raises"]
    np.testing.assert_array_equal(r["scatter_shared"], np.arange(16.0).reshape(WORLD, 8))
    np.testing.assert_array_equal(r["gather"], np.stack([v, v * 9]))
    np.testing.assert_array_equal(r["all_reduce_prod_pos"], np.abs(v) * np.abs(v * 9))


def test_sgd_parity(results):
    """Paper Appendix A: multi-worker SGD with all-reduce(avg) equals the
    serial single-worker program, and the reference's 2-device run."""
    ranks, ref = results
    np.testing.assert_allclose(ranks[0]["sgd"], _serial_sgd(), rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["sgd"], ref["sgd"], rtol=1e-6)
