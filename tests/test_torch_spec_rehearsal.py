"""``chip_smoke.py``'s dense speculative-decoding phases (3j, 3k, 3l)
rehearsed at smoke width on the CPU, and the ``rehearsal`` fixture that
``tests/test_torch_spec_decode.py``'s zamba phase (5d) and
``tests/test_torch_mesh_rehearsal.py``'s phase 3p share.

A file of its own: the rehearsal is the longest test of the suite, and
under ``--dist loadfile`` a file runs on one worker, so beside the rest of
the spec-decode tests it set the suite's wall time.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.aot import CudaGraphProgram
from repro_torch.serve import EngineConfig, ServeEngine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its smoke-width ops are too
    small to split, and beside the suite's other workers more threads only
    contend (the chip_smoke rehearsals ran many times slower with 8)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _EagerGraph(CudaGraphProgram):
    """The CPU's stand-in for a captured graph: building runs ``fn`` once
    (the first call returns that output, as a graph's does); every later
    call runs ``fn`` eagerly and counts as a replay.  Each call goes through
    the (counting) kernel wrappers, as each replay adds its captured
    launches on the card."""

    def __init__(self, fn, args, *, generators=()):
        self._fn, self._first, self._replay_next = fn, fn(*args), False
        self.launches, self.replays = [], 0

    def __call__(self, *args):
        if not self._replay_next:
            out, self._first, self._replay_next = self._first, None, True
            return out
        self.replays += 1
        return self._fn(*args)


def _counting(fn):
    def wrapper(*a, **kw):
        wrapper.launches += 1
        return fn(*a, **kw)
    wrapper.__name__, wrapper.launches = fn.__name__, 0
    return wrapper


@pytest.fixture
def rehearsal(monkeypatch):
    """``chip_smoke`` at smoke width in fp32 on the CPU: ``get_config``
    gives the smoke configs, the layer counts follow, the seven kernel
    wrappers count every call (their plain versions run), the engines
    register their eager decode and spec programs as graphs
    (``_EagerGraph``), the card's synchronize and memory calls are no-ops,
    and the profiled code runs once unrecorded."""
    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.models import zamba

    cs = _chip_smoke()
    smoke = lambda arch: dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    monkeypatch.setattr(configs, "get_config", smoke)
    monkeypatch.setattr(cs, "N_LAYERS", smoke("smollm-360m").n_layers)
    monkeypatch.setattr(cs, "ZAMBA_LAYERS", smoke("zamba2-1.2b").n_layers)
    monkeypatch.setattr(cs, "ZAMBA_SHARED", zamba.n_shared_invocations(smoke("zamba2-1.2b")))
    for mod, name in ((fops, "flash_attention"), (pops, "paged_attention"),
                      (pops, "paged_attention_range"), (rops, "rmsnorm"),
                      (rops, "rmsnorm_add"), (rops, "rmsnorm_gated"), (sops, "ssd")):
        monkeypatch.setattr(mod, name, _counting(getattr(mod, name)))
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    # no device to profile: the profiled code runs, nothing is recorded
    monkeypatch.setattr(cs, "profiled", lambda torch, run: (run(), [])[1])
    monkeypatch.setattr(cs, "device_profile", lambda torch, fn, iters=50: (fn(), (None, {}))[1])

    def decode_entry(self, *, stochastic, masked):
        key = self._decode_key(stochastic, masked)
        fn = self.aot.get(key, lambda: self.decode_program(stochastic=stochastic,
                                                           masked=masked))
        return self.graphs.get(key, lambda: _EagerGraph(fn, (self.params, self.state)))

    def spec_entry(self, *, stochastic, masked):
        key = self._spec_key(stochastic, masked)
        fn = self.aot.get(key, lambda: self.spec_program(stochastic=stochastic, masked=masked))
        return self.graphs.get(key, lambda: _EagerGraph(
            fn, (self.params, self.draft_params, self.state)))

    monkeypatch.setattr(ServeEngine, "_decode_entry", decode_entry)
    monkeypatch.setattr(ServeEngine, "_spec_entry", spec_entry)
    return cs


def test_chip_smoke_spec_phases(rehearsal):
    """``chip_smoke.py``'s phases 3j, 3k and 3l run whole at smoke width,
    every gate of the card's included: 3j's graph check and builds, every
    stream bitwise phase 3's (3j, 3k) or 3b's or its prefix witness's
    (3l), the counter identities (``spec_identities``: a draft prefill for
    each prefill, restore and release) and the launches the counters
    predict (``spec_launches``).  The counts themselves differ on the card:
    how many proposals a round accepts depends on the weights' values
    (full width, bf16 there), and with it when lanes preempt and resume."""
    cs = rehearsal
    from repro_torch.models import lm

    dev = torch.device("cpu")
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), compute_dtype="float32",
                              attn_impl="kernel")
    params = lm.init(cfg, seed=0, device=dev)
    phase3 = cs.requests(cfg.vocab)
    ec3 = EngineConfig(max_slots=cs.MAX_SLOTS, max_len=cs.MAX_LEN, kv_layout="paged",
                       page_size=cs.PAGE, paged_attn="kernel")
    eng, rids, _, _, _ = cs.serve(torch, cfg, params, phase3, ec3, dev)
    results = {"nvidia_smi": "a CPU rehearsal",
               "phase3_streams": [list(eng.completions[r].tokens) for r in rids],
               "main_path": dict(tokens_per_s=1.0, decode_step_ms_median=1.0),
               "tier": {"3f": dict(tokens_per_s=1.0)}, "features": {}}
    reqs_b = cs.feature_requests(cfg.vocab)
    b, streams_b, _, eng_b = cs.feature_run(torch, cfg, params, reqs_b, cs.feature_engine(), dev,
                                            engine_cls=cs.start_log_engine())
    results["features"]["3b"] = b
    results["phase3b_streams"] = streams_b
    results["phase3b_starts"] = eng_b.prefill_starts(len(reqs_b))
    launches = cs.spec_path(torch, dev, results)
    sp = results["spec"]
    assert set(launches) == {"3j", "3k", "3l"}
    assert sp["3k"]["counters"]["preemptions"] > 0 and sp["3l"]["counters"]["preemptions"] > 0
    assert sp["3l"]["counters"]["prefix_hit_tokens"] > 0
    for ph in ("3j", "3k", "3l"):
        assert sp[ph]["spec_accepted"] > 0 and sp[ph]["spec_rejected"] > 0, ph

