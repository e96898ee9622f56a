"""``chip_smoke.py``'s phases 10, 11 and 12 (xlstm-1.3b on the slotted
engine, whisper-tiny and internvl2-76b on the static loop) rehearsed at
smoke width on the CPU, with the ``rehearsal`` fixture of
``tests/test_torch_spec_rehearsal.py`` (smoke configs in fp32, counting
kernel wrappers, eager programs registered as graphs, the card's
synchronize and memory calls no-ops, nothing profiled).

Every gate of the three phases runs: the engine's (full budgets, the graph
check's 8 replays bitwise the eager program, builds flat after
``prebuild``, ``check_invariants`` after every step, a second run's
streams) and the static loop's (the launch formulas, a second run's
streams), and the kernel path's logits and blocks against the plain
path's, which on the CPU run the same plain code.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from test_torch_spec_rehearsal import rehearsal  # noqa: F401  (the fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def frontier(rehearsal, monkeypatch):
    """The rehearsal with the three phases' depths at the smoke configs'
    and the memory calls they add stubbed."""
    cs = rehearsal
    smoke = lambda arch: get_smoke_config(arch)
    monkeypatch.setattr(cs, "XLSTM_LAYERS", smoke("xlstm-1.3b").n_layers)
    monkeypatch.setattr(cs, "WHISPER_LAYERS", smoke("whisper-tiny").n_layers)
    monkeypatch.setattr(cs, "VLM_LAYERS", smoke("internvl2-76b").n_layers)
    monkeypatch.setattr(cs, "VLM_FP32_LAYERS", 1)
    monkeypatch.setattr(cs, "XLSTM_FP32_LAYERS", smoke("xlstm-1.3b").slstm_every)
    monkeypatch.setattr(cs, "profile_decode", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    return cs


def _results():
    return {"nvidia_smi": "a CPU rehearsal"}


def test_chip_smoke_xlstm_phase(frontier):
    """Phase 10 whole: the rmsnorm launches ``(2 L + 1)`` a prefill and a
    decode step and no other kernel's; the logits and blocks in both
    dtypes."""
    cs = frontier
    results = _results()
    launches = cs.xlstm_path(torch, torch.device("cpu"), results)
    e2e = results["xlstm"]
    L = cs.XLSTM_LAYERS
    assert launches == {"flash_attention": 0, "paged_attention": 0, "rmsnorm_add": 0,
                        "rmsnorm": (2 * L + 1) * (e2e["prefills"] + e2e["decode_steps"])}
    assert e2e["prefills"] == 16 and e2e["second_run_streams_equal"]
    assert not results["xlstm_graph_check"]["mismatches"]
    assert set(results["xlstm_blocks"]) == {"bfloat16", "float32"}
    assert set(results["xlstm_logits"]) == {"bfloat16", "float32", "float32_full_depth"}
    assert results["xlstm_logits"]["float32"]["layers"] == cs.XLSTM_FP32_LAYERS


def test_chip_smoke_frontend_phases(frontier):
    """Phases 11 and 12 whole: flash ``E + 2 L`` (whisper) and ``L``
    (internvl2) a prefill, the norms per prefill and decode step, a second
    run's streams, the logit checks."""
    cs = frontier
    dev = torch.device("cpu")
    results = _results()
    w = cs.whisper_path(torch, dev, results)
    L = cs.WHISPER_LAYERS
    assert w["flash_attention"] == 3 * L and results["whisper"]["second_run_streams_equal"]
    assert w == cs.whisper_launches(cs.WHISPER_NEW)
    assert w["rmsnorm_add"] == 3 * L + 2 * L * cs.WHISPER_NEW
    v = cs.vlm_path(torch, dev, results)
    assert v == cs.vlm_launches(cs.VLM_NEW) and v["flash_attention"] == cs.VLM_LAYERS
    assert set(results["vlm_logits"]) == {"bfloat16", "float32"}
    assert results["vlm"]["n_ctx"] == get_smoke_config("internvl2-76b").frontend_tokens \
        + cs.VLM_PROMPT
