"""``repro_torch.core`` data objects and §5.1 slicing against the reference.

The port of ``tests/test_core_data.py``: ``SynkData`` growth and its numpy
interface (the port's class is the reference's numpy code, so both run
the same operations and must hold the same arrays), and ``sliced_call``
against the reference's for every op in ``REDUCE_OPS`` on the same numpy
inputs (fp32; within 1e-6 relative for mean and sum, whose slice sums
add in another order, and bitwise for max, min, concat, last and
``None``).  The reference draws its cases with hypothesis; here they are
the same grid, every case.  Broadcast arguments keep their original
values across slices, and a function that writes into one raises (an
eager function can, a JAX one cannot).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jsynk
import repro_torch.core as tsynk
from repro.core.slicing import sliced_call as jsliced
from repro.core.specs import REDUCE_OPS as JREDUCE_OPS
from repro.core.specs import Reduce as JReduce
from repro_torch.core.slicing import sliced_call as tsliced
from repro_torch.core.specs import REDUCE_OPS, Reduce

FNS = {
    "mean": (jnp.mean, torch.mean),
    "sum": (jnp.sum, torch.sum),
    "max": (jnp.max, torch.max),
    "min": (jnp.min, torch.min),
}


@pytest.mark.parametrize("synk", [jsynk, tsynk], ids=["jax", "torch"])
def test_synkdata_overallocation_growth(synk):
    x = np.arange(12.0, dtype=np.float32).reshape(6, 2)
    d = synk.data(x, oversize=2.0)
    assert d.capacity >= 12 // 2
    assert d.shape == (6, 2)
    buf_before = d._buffer
    d.set_length(9)                   # grow within capacity: no realloc
    assert d._buffer is buf_before
    assert d.shape == (9, 2)
    d.set_length(4)                   # shrink: view only
    np.testing.assert_array_equal(d.array, x[:4])
    d.set_length(d.capacity + 5)      # beyond capacity: realloc, data kept
    np.testing.assert_array_equal(d.array[:4], x[:4])
    d.free()
    assert len(d) == 0


@pytest.mark.parametrize("synk", [jsynk, tsynk], ids=["jax", "torch"])
def test_synkdata_numpy_interface(synk):
    x = np.arange(10.0, dtype=np.float32)
    d = synk.data(x)
    d[3] = 99.0
    assert d[3] == 99.0
    assert np.asarray(d).shape == (10,)
    np.testing.assert_array_equal(d.excerpt([1, 3]), np.array([1.0, 99.0]))


def test_synkdata_same_operations_same_arrays():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 3)).astype(np.float32)
    dj, dt = jsynk.data(x, oversize=1.5), tsynk.data(x, oversize=1.5)
    for d in (dj, dt):
        d.set_length(10)
        d[7:] = 1.0
        d.set_length(5)
    assert dt.capacity == dj.capacity
    np.testing.assert_array_equal(dt.array, dj.array)
    np.testing.assert_array_equal(dt.excerpt([4, 0, 2]), dj.excerpt([4, 0, 2]))
    with pytest.raises(ValueError):
        tsynk.data(x, oversize=0.5)


def test_reduce_ops_are_the_reference_s():
    assert REDUCE_OPS == JREDUCE_OPS


@pytest.mark.parametrize("op", ["mean", "sum", "max", "min"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("b", [8, 16, 32])
def test_slicing_aggregation_equivalence(b, k, op):
    """Paper §5.1 invariant: slicing must not change results; and the
    port's slicing gives the reference's."""
    x = np.random.default_rng(b * 100 + k).normal(size=(b, 4)).astype(np.float32)
    fj, ft = FNS[op]
    direct = ft(torch.from_numpy(x))
    got = tsliced(ft, [torch.from_numpy(x)], [True], Reduce(op), k)
    want = jsliced(fj, [jnp.asarray(x)], [True], JReduce(op), k)
    np.testing.assert_allclose(got, direct, rtol=1e-5, atol=1e-6)
    if op in ("max", "min"):
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("b", [8, 24])
def test_slicing_concat_last_and_none(b, k):
    x = np.random.default_rng(b + k).normal(size=(b, 3)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for op in ("concat", None):
        got = tsliced(lambda x: x * 2.0, [xt], [True], Reduce(op), k)
        want = jsliced(lambda x: x * 2.0, [xj], [True], JReduce(op), k)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_allclose(got, x * 2, rtol=1e-6)
    last = tsliced(lambda x: x[0] * 2.0, [xt], [True], Reduce("last"), k)
    np.testing.assert_array_equal(
        last, np.asarray(jsliced(lambda x: x[0] * 2.0, [xj], [True], JReduce("last"), k)))
    np.testing.assert_array_equal(last, x[b - b // k] * 2.0)
    last = tsliced(lambda x: torch.sum(x, 0), [xt], [True], Reduce("last"), k)
    np.testing.assert_allclose(last, x[-(b // k):].sum(0), rtol=1e-5)


def test_slicing_tree_outputs_prefix_spec():
    x = np.random.default_rng(3).normal(size=(16, 2)).astype(np.float32)
    got = tsliced(lambda x: (torch.mean(x), {"a": torch.max(x), "b": x * 1.0}),
                  [torch.from_numpy(x)], [True],
                  (Reduce("mean"), {"a": Reduce("max"), "b": Reduce("concat")}), 4)
    want = jsliced(lambda x: (jnp.mean(x), {"a": jnp.max(x), "b": x * 1.0}),
                   [jnp.asarray(x)], [True],
                   (JReduce("mean"), {"a": JReduce("max"), "b": JReduce("concat")}), 4)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-6)
    np.testing.assert_array_equal(got[1]["a"], np.asarray(want[1]["a"]))
    np.testing.assert_array_equal(got[1]["b"], np.asarray(want[1]["b"]))


def test_slicing_bf16_means_accumulate_in_fp32():
    x = np.random.default_rng(4).normal(size=(64, 8)).astype(np.float32)
    got = tsliced(lambda x: x.mean(0), [torch.from_numpy(x).bfloat16()], [True],
                  Reduce("mean"), 8)
    want = jsliced(lambda x: x.mean(0), [jnp.asarray(x, jnp.bfloat16)], [True],
                   JReduce("mean"), 8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float(), np.asarray(want, np.float32), rtol=1e-2)


def test_slicing_indivisible_raises():
    for sliced, x, red in ((tsliced, torch.ones(10, 2), Reduce),
                           (jsliced, jnp.ones((10, 2)), JReduce)):
        with pytest.raises(ValueError, match="num_slices"):
            sliced(lambda x: x.mean(), [x], [True], red("mean"), 3)


def test_slicing_broadcast_args_use_original_values():
    """Paper: 'all slices are computed using the original values'."""
    x = np.arange(8.0, dtype=np.float32).reshape(8, 1)
    out = tsliced(lambda x, w: torch.sum(x) * w, [torch.from_numpy(x), torch.tensor(3.0)],
                  [True, False], Reduce("sum"), 4)
    want = jsliced(lambda x, w: jnp.sum(x) * w, [jnp.asarray(x), jnp.float32(3.0)],
                   [True, False], JReduce("sum"), 4)
    np.testing.assert_allclose(float(out), float(np.sum(x) * 3.0), rtol=1e-6)
    np.testing.assert_allclose(float(out), float(want), rtol=1e-6)

    def mutates(x, w):
        w.add_(1.0)               # an in-place update to a broadcast input
        return torch.sum(x) * w
    with pytest.raises(RuntimeError, match="original values"):
        tsliced(mutates, [torch.from_numpy(x), torch.tensor(3.0)], [True, False],
                Reduce("sum"), 4)
