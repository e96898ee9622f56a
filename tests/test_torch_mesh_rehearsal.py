"""``chip_smoke.py``'s phase 3p (the engine's features on the ``(1, 1)``
mesh) rehearsed at smoke width on the CPU, with the ``rehearsal`` fixture
of ``tests/test_torch_spec_rehearsal.py``.  A file of its own, so that
under ``--dist loadfile`` it runs on another worker than the spec
rehearsal.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.serve import EngineConfig
from test_torch_spec_rehearsal import rehearsal  # noqa: F401  (the fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other rehearsals."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_mesh_features_phase(rehearsal, monkeypatch):
    """``chip_smoke.py``'s phase 3p whole at smoke width, on a ``(1, 1)``
    mesh over a one-rank gloo group in place of the card's NCCL groups,
    every gate of the card's included: ``TIER_3F`` exactly (the schedule
    does not depend on the values), 3h's events, the spec graph's 8 rounds
    bitwise the eager program, a round's collectives by
    ``spec_collectives``, the streams bitwise the mesh-less runs', the
    launches by ``mesh_feature_launches``."""
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import lm

    cs = rehearsal
    gloo = lmesh.init_group
    monkeypatch.setattr(lmesh, "init_group", lambda backend, rank, world, address, device=None,
                        **kw: gloo("gloo", rank, world, address, device="cpu", timeout_s=60))
    dev = torch.device("cpu")
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), compute_dtype="float32",
                              attn_impl="kernel")
    params = lm.init(cfg, seed=0, device=dev)
    phase3 = cs.requests(cfg.vocab)
    ec3 = EngineConfig(max_slots=cs.MAX_SLOTS, max_len=cs.MAX_LEN, kv_layout="paged",
                       page_size=cs.PAGE, paged_attn="kernel")
    streams = {}
    # 3p's slotted spec run serves the first MAX_SLOTS requests
    for layout, reqs in (("paged", phase3), ("slotted", phase3[:cs.MAX_SLOTS])):
        eng, rids, _, _, _ = cs.serve(torch, cfg, params, reqs,
                                      dataclasses.replace(ec3, kv_layout=layout), dev)
        streams[layout] = [list(eng.completions[r].tokens) for r in rids]
    stand_in = dict(tokens_per_s=1.0)
    results = {"nvidia_smi": "a CPU rehearsal", "phase3_streams": streams["paged"],
               "phase3_slotted_streams": streams["slotted"], "tier": {"3f": stand_in},
               "spec": {"3j": dict(tokens_per_s=1.0, profile={}), "3k": stand_in}}
    launches = cs.mesh_features_path(torch, dev, results)
    mf = results["mesh_features"]
    assert set(launches) == {"3f", "3h", "3j paged", "3j slotted", "3k"}
    assert launches["3j paged"]["paged_attention_range"] > 0
    assert launches["3j slotted"]["paged_attention_range"] == 0
    assert mf["3f"]["tier_counters"] == cs.TIER_3F
    assert mf["3k"]["counters"]["preemptions"] > 0
    assert not mf["3j"]["graph_check"]["mismatches"]
