"""The port's ``CheckpointManager`` (``repro_torch.checkpoint``): the
reference's on-disk format and its fault tolerance, mirroring
``tests/test_optim_checkpoint.py`` and ``tests/test_fault_tolerance.py``.

Checkpoints are data movement, so every comparison here is exact, and a
checkpoint written by either package restores in the other.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as manager_mod


def _tree(scale=1.0):
    return {"a": torch.arange(6.0).reshape(2, 3) * scale,
            "b": {"c": torch.ones(4) * scale, "step": torch.tensor(3, dtype=torch.int32)}}


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    else:
        want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
        got = np.asarray(got)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_roundtrip_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_k=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": _tree(s), "opt": {"step": torch.tensor(s)}})
    assert mgr.all_steps() == [3, 4]          # keep_k pruned
    step, state = mgr.restore({"params": _tree(), "opt": {"step": torch.tensor(0)}})
    assert step == 4
    _assert_tree_equal(state["params"], _tree(4))
    assert int(state["opt"]["step"]) == 4
    # restore onto meta-tensor templates (shapes only)
    meta = {"params": {"a": torch.empty(2, 3, device="meta"),
                       "b": {"c": torch.empty(4, device="meta"),
                             "step": torch.empty((), device="meta")}}}
    _assert_tree_equal(mgr.restore(meta, step=3)[1]["params"], _tree(3))


def test_atomic_async_save_leaves_no_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_k=3)
    mgr.save(5, {"params": _tree()}, blocking=False, extra_meta={"flat_engine": "zero"})
    mgr.wait()
    assert not any(f.startswith(".tmp") for f in os.listdir(tmp_path))
    assert mgr.latest_step() == 5
    assert mgr.load_meta() == (5, {"step": 5, "groups": {"params": ["a", "b/c", "b/step"]},
                                   "flat_engine": "zero"})


def test_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": {"a": torch.ones(3)}})
    with pytest.raises(ValueError, match="checkpoint"):
        mgr.restore({"params": {"a": torch.ones(4)}})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"params": {"z": torch.ones(3)}})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"params": {}})


def test_crash_mid_save_restores_previous_step(tmp_path, monkeypatch):
    """Die between the tmp write and the atomic rename: the previous
    checkpoint stays the latest, and the next manager sweeps the orphan."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": _tree()})
    with monkeypatch.context() as m:
        m.setattr(manager_mod.os, "rename",
                  lambda *a: (_ for _ in ()).throw(OSError("killed")))
        with pytest.raises(OSError):
            mgr.save(2, {"params": _tree(2)})
    assert os.path.isdir(tmp_path / ".tmp-2")
    step, state = mgr.restore({"params": _tree()})
    assert step == 1
    _assert_tree_equal(state["params"], _tree())
    mgr2 = CheckpointManager(str(tmp_path))
    assert not any(f.startswith(".tmp") for f in os.listdir(tmp_path))
    assert mgr2.latest_step() == 1


def test_async_save_failure_reraises(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    boom = lambda *a, **k: (_ for _ in ()).throw(OSError("disk full"))
    with monkeypatch.context() as m:
        m.setattr(manager_mod.np, "savez", boom)
        mgr.save(1, {"params": _tree()}, blocking=False)
        with pytest.raises(RuntimeError, match="async checkpoint save"):
            mgr.wait()
    mgr.wait()                    # error consumed, manager usable again
    with monkeypatch.context() as m:
        m.setattr(manager_mod.np, "savez", boom)
        mgr.save(2, {"params": _tree()}, blocking=False)
        with pytest.raises(RuntimeError, match="async checkpoint save"):
            mgr.save(3, {"params": _tree()})   # save() waits first
    mgr.save(4, {"params": _tree()})
    assert mgr.latest_step() == 4


def test_save_retries_transient_io(tmp_path, monkeypatch):
    sleeps = []
    mgr = CheckpointManager(str(tmp_path), save_retries=3, retry_backoff_s=0.01,
                            sleep=sleeps.append)
    real = manager_mod.np.savez
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise OSError("ENOSPC")
        return real(*a, **k)

    with monkeypatch.context() as m:
        m.setattr(manager_mod.np, "savez", flaky)
        mgr.save(1, {"params": _tree()})
    assert calls["n"] == 3 and sleeps == [0.01, 0.02]
    _assert_tree_equal(mgr.restore({"params": _tree()})[1]["params"], _tree())


def test_save_retry_exhaustion_still_raises(tmp_path, monkeypatch):
    sleeps = []
    mgr = CheckpointManager(str(tmp_path), save_retries=2, retry_backoff_s=0.01,
                            sleep=sleeps.append)
    with monkeypatch.context() as m:
        m.setattr(manager_mod.os, "rename",
                  lambda *a: (_ for _ in ()).throw(OSError("gone")))
        with pytest.raises(OSError):
            mgr.save(1, {"params": _tree()})
    assert sleeps == [0.01] and mgr.latest_step() is None
    with pytest.raises(ValueError, match="save_retries"):
        CheckpointManager(str(tmp_path), save_retries=0)


def test_jax_checkpoint_restores_in_port(tmp_path):
    jtree = {"a": jnp.arange(6.0).reshape(2, 3), "b": {"c": jnp.ones(4),
                                                      "step": jnp.int32(3)}}
    JCheckpointManager(str(tmp_path)).save(7, {"params": jtree, "opt": {"step": jnp.int32(7)}},
                                           extra_meta={"flat_engine": "faithful"})
    mgr = CheckpointManager(str(tmp_path))
    step, state = mgr.restore({"params": _tree(), "opt": {"step": torch.tensor(0)}})
    assert step == 7 and mgr.load_meta()[1]["flat_engine"] == "faithful"
    _assert_tree_equal(state["params"], _tree())
    assert int(state["opt"]["step"]) == 7


def test_port_checkpoint_restores_in_jax(tmp_path):
    CheckpointManager(str(tmp_path)).save(9, {"params": _tree(2.0)})
    jtmpl = {"a": jnp.zeros((2, 3)), "b": {"c": jnp.zeros(4), "step": jnp.int32(0)}}
    step, state = JCheckpointManager(str(tmp_path)).restore({"params": jtmpl})
    assert step == 9
    _assert_tree_equal(state["params"], _tree(2.0))
