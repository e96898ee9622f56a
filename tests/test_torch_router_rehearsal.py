"""``chip_smoke.py``'s router and traced phases (3m, 3n) rehearsed at
smoke width on the CPU.

The engine settings are the card's (8 lanes, max_len 1024, 16-position
pages) and so is the traffic (phase 3's 16 requests); only the widths are
the smoke config's, in fp32.  The schedule does not depend on the values
computed (greedy, no EOS, a step clock), so the counters this run gives
are the ones the card must show: ``chip_smoke.ROUTER_3M`` and
``ROUTER_3M_REPLICAS``.  Every other gate of the two phases runs too.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.aot import CudaGraphProgram
from repro_torch.serve import EngineConfig, ServeEngine


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _EagerGraph(CudaGraphProgram):
    """The CPU's stand-in for a captured graph: building runs ``fn`` once
    (the first call returns that output, as a graph's does); every later
    call runs ``fn`` eagerly, through the counting kernel wrappers, as
    each replay adds its captured launches on the card."""

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
def rehearsal(monkeypatch, tmp_path):
    """``chip_smoke`` at smoke width in fp32 on the CPU: ``get_config``
    gives the smoke config (the launcher's too), the layer count follows,
    the dense kernel wrappers count every call (their plain versions run),
    the engines register their eager decode programs as graphs, the card's
    synchronize and memory calls are stand-ins, nothing is profiled, and
    the traces go to a temporary directory."""
    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.launch import serve as launcher

    cs = _chip_smoke()
    smoke = lambda arch: dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    monkeypatch.setattr(configs, "get_config", smoke)
    monkeypatch.setattr(launcher, "get_config", smoke)
    monkeypatch.setattr(cs, "N_LAYERS", smoke("smollm-360m").n_layers)
    monkeypatch.setattr(cs, "HERE", tmp_path)
    monkeypatch.setattr(cs, "TRACE_DIR", tmp_path / "build" / "chip_smoke")
    for mod, name in ((fops, "flash_attention"), (pops, "paged_attention"), (rops, "rmsnorm"),
                      (rops, "rmsnorm_add")):
        monkeypatch.setattr(mod, name, _counting(getattr(mod, name)))
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "profile_decode", lambda *a, **k: None)

    def decode_entry(self, *, stochastic, masked):
        key = self._decode_key(stochastic, masked)
        fn = self.aot.get(key, lambda: self.decode_program(stochastic=stochastic,
                                                           masked=masked))
        return self.graphs.get(key, lambda: _EagerGraph(fn, (self.params, self.state)))

    monkeypatch.setattr(ServeEngine, "_decode_entry", decode_entry)
    return cs


def test_chip_smoke_router_phases(rehearsal):
    """``chip_smoke.py``'s phases 3m and 3n run whole at smoke width with
    the full-width engine settings, every gate of the card's included:
    3m's counters are ``ROUTER_3M`` and ``ROUTER_3M_REPLICAS`` (the
    schedule does not depend on the values computed), every stream phase
    3's, one graph capture per replica that decoded; 3n's traced streams,
    launches and trace, and the launcher's two-replica drain."""
    cs = rehearsal
    from repro_torch.models import lm

    dev = torch.device("cpu")
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), compute_dtype="float32",
                              attn_impl="kernel")
    params = lm.init(cfg, seed=0, device=dev)
    kernels = cs.dense_launch_kernels()
    for k in kernels:
        k.launches = 0
    ec3 = EngineConfig(max_slots=cs.MAX_SLOTS, max_len=cs.MAX_LEN, kv_layout="paged",
                       page_size=cs.PAGE, paged_attn="kernel")
    eng, rids, steps, prefilled, _ = cs.serve(torch, cfg, params, cs.requests(cfg.vocab), ec3,
                                              dev)
    results = {"phase3_streams": [list(eng.completions[r].tokens) for r in rids],
               "profile": None,
               "main_path": dict(tokens_per_s=1.0, decode_step_ms_median=1.0,
                                 launches={k.__name__: k.launches for k in kernels})}
    launches = cs.router_path(torch, dev, results)
    r = results["router"]
    assert r["identical_to_phase3"] == 16 and r["graph_builds"] == cs.ROUTER_REPLICAS
    assert r["counters"]["failovers"] > 0 and r["counters"]["migrated"] > 0
    assert r["counters"]["stalls_detected"] == 1 and r["counters"]["replicas_dead"] == 2
    assert launches["flash_attention"] > 0
    traced = cs.traced_path(torch, dev, results)
    t = results["traced"]
    assert traced == results["main_path"]["launches"]
    assert t["trace"]["requests"] == t["trace"]["terminals"] == 16
    assert (cs.TRACE_DIR / "phase3n_trace.json").is_file()
    assert t["launcher"]["status_ok"] == 8 and t["launcher"]["migrated"] >= 0
