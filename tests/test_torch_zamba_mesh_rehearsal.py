"""``chip_smoke.py``'s zamba2 mesh phases rehearsed at smoke width on the
CPU, with the ``rehearsal`` fixture of ``tests/test_torch_spec_rehearsal.py``
and a one-rank gloo group in place of the card's NCCL groups: 5m (phase 5's
engine on a ``(1, 1)`` mesh), 14b with its mesh run 14m (the head-split
train step through the gated norm's split entry), and 2e's split-entry
checks.  A file of its own, so that under ``--dist loadfile`` it runs on
another worker than the other rehearsals.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.aot import CudaGraphProgram
from repro_torch.models import common
from test_torch_spec_rehearsal import _counting, rehearsal  # noqa: F401  (the fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other rehearsals."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def zamba_rehearsal(rehearsal, monkeypatch):
    """The ``rehearsal`` fixture, the split entry counted, ``init_group``
    over gloo on the CPU, the card's memory calls no-ops and the profiles
    not taken; returns chip_smoke."""
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.launch import mesh as lmesh

    cs = rehearsal
    monkeypatch.setattr(rops, "rmsnorm_gated_split", _counting(rops.rmsnorm_gated_split))
    gloo = lmesh.init_group
    monkeypatch.setattr(lmesh, "init_group", lambda backend, rank, world, address, device=None,
                        **kw: gloo("gloo", rank, world, address, device="cpu", timeout_s=60))
    for name in ("empty_cache",):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "profile_decode", lambda *a, **k: None)
    monkeypatch.setattr(cs, "profile_train_step", lambda *a, **k: None)
    return cs


class _MeshGraph(CudaGraphProgram):
    """The CPU's stand-in for a decode graph captured under a mesh program:
    building runs the program once and counts its collectives twice (the
    card's warm step and its capture each issue them in Python); every
    later call runs it eagerly, as a replay, and leaves ``common.COUNTS``
    as it found it (a replay's collectives are the graph's, not Python's)."""

    def __init__(self, fn, args, *, generators=()):
        before = dict(common.COUNTS)
        self._fn, self._first, self._replay_next = fn, fn(*args), False
        for k, n in before.items():
            common.COUNTS[k] += common.COUNTS[k] - n
        self.launches, self.replays = [], 0

    def __call__(self, *args):
        if not self._replay_next:
            out, self._first, self._replay_next = self._first, None, True
            return out
        self.replays += 1
        saved = dict(common.COUNTS)
        out = self._fn(*args)
        common.COUNTS.update(saved)
        return out


def test_chip_smoke_zamba_mesh_serve_phase(zamba_rehearsal, monkeypatch):
    """Phase 5m whole at smoke width: phase 5's engine settings and
    requests on a ``(1, 1)`` mesh, every gate of the card's: the streams
    bitwise the mesh-less engine's, the launches phase 5's formulas (the
    split entry never launched in serving), the run's and one decode
    step's collectives by ``zamba_serve_collectives``, the KV bytes."""
    from repro_torch.models import zamba
    from repro_torch.serve import EngineConfig, ServeEngine

    cs = zamba_rehearsal

    def decode_entry(self, *, stochastic, masked):
        key = self._decode_key(stochastic, masked)
        fn = self.aot.get(key, lambda: self.decode_program(stochastic=stochastic,
                                                           masked=masked))
        return self.graphs.get(key, lambda: _MeshGraph(fn, (self.params, self.state)))

    monkeypatch.setattr(ServeEngine, "_decode_entry", decode_entry)
    dev = torch.device("cpu")
    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"), compute_dtype="float32",
                              attn_impl="kernel")
    params = zamba.init(cfg, seed=0, device=dev)
    reqs = cs.requests(cfg.vocab)
    ec = EngineConfig(max_slots=cs.MAX_SLOTS, max_len=cs.MAX_LEN, kv_layout="slotted")
    eng, rids, steps, prefilled, wall = cs.serve(torch, cfg, params, reqs, ec, dev)
    want = [list(eng.completions[r].tokens) for r in rids]
    base = dict(tokens_per_s=1.0, decode_step_ms_median=1.0,
                kv_reserved_bytes=eng.kv_reserved_bytes)
    row = cs.zamba_mesh_serve(torch, cfg, params, reqs, ec, dev, want, base)
    assert row["identical"] == len(reqs) and row["mesh"] == "(data 1, model 1)"
    assert row["launches"]["rmsnorm_gated_split"] == 0 and row["launches"]["ssd"] > 0
    assert row["collectives_run"]["norm_sum"] == 0
    assert row["collectives_decode_step"]["decode_combine"] == 2 * zamba.n_shared_invocations(cfg)


def test_chip_smoke_zamba_mesh_train_phase(zamba_rehearsal, monkeypatch):
    """Phase 14b whole at smoke width with its mesh run (14m): the
    replicated rules, FSDP and the ``(1, 1)`` mesh from one init, step 1
    bitwise equal across the three (loss, gradient norm, parameter
    digests), the mesh's launches (the split entry twice a call, forward
    and recompute) and collectives by formula (``mesh_collectives``)."""
    import repro_torch.configs as configs

    cs = zamba_rehearsal
    smoke = get_smoke_config("zamba2-1.2b")
    monkeypatch.setattr(configs, "get_config", lambda arch: dataclasses.replace(
        get_smoke_config(arch), compute_dtype="bfloat16"))
    monkeypatch.setattr(cs, "ZT_FIRST_SEGMENT", smoke.attn_every)
    monkeypatch.setattr(cs, "ZT_SEQ", 32)
    results = {}
    launches = cs.zamba_fsdp_path(torch, torch.device("cpu"), results)
    row = results["zamba_fsdp_train"]
    mesh = row["step1_rules"]["mesh"]
    L, per = smoke.attn_every, cs.ZT_SLICES * cs.ZF_STEPS
    assert launches["rmsnorm_gated_split"] == 0 and launches["rmsnorm_gated"] == 2 * L * per
    assert mesh["launches"]["rmsnorm_gated_split"] == 4 * L * per
    assert mesh["launches"]["rmsnorm_gated"] == 0
    assert mesh["rules"]["sp"] is False and mesh["model_partial"] == 4
    assert mesh["collectives"]["norm_sum"] == 4 * L * per
    assert all(mesh["step1_bitwise"].values()) and mesh["params_digest_equal"]


def test_chip_smoke_rmsnorm_split_checks(zamba_rehearsal, monkeypatch):
    """Phase 2e's split-entry checks at a few rows of zamba2's d_inner,
    bf16 and fp32: the row in 1, 2 and 4 shards against the plain version
    and the whole-row gated norm (one shard bitwise), and its timing rows
    (profiler stubbed: the calls run, nothing is recorded)."""
    cs = zamba_rehearsal
    monkeypatch.setattr(cs, "RMSNORM_SPLIT_SHAPES", ((16, cs.ZAMBA_D_INNER), (8, cs.ZAMBA_D_INNER)))
    monkeypatch.setattr(cs, "COLD_BYTES", 1 << 20)
    monkeypatch.setattr(cs, "device_profile", lambda torch, fn, iters=50: (
        fn(), (None, {"sumsq": {"calls": 1.0}, "scaled": {"calls": 1.0}}))[1])
    monkeypatch.setattr(cs, "device_ms", lambda torch, fn, iters=50: (fn(), None)[1])
    monkeypatch.setattr(cs, "time_ms", lambda torch, fn, iters, warmup=3: (fn(), None)[1])
    monkeypatch.setattr(cs, "host_us", lambda torch, fn, calls=1000: (fn(), 0.0)[1])
    results = {}
    cs.check_rmsnorm_split(torch, torch.device("cpu"), results)
    cases = results["rmsnorm_split_cases"]
    assert len(cases) == 2 * 2 * 3
    assert all(c["bitwise_whole"] for c in cases if c["shards"] == 1)
    assert [t["shape"] for t in results["rmsnorm_split_timing"]] == [[16, 4096], [8, 4096]]
    assert all(t["bound_by"] == "bytes" for t in results["rmsnorm_split_timing"])
