"""``EngineConfig(fused_sampling=False)`` in the port: the programs return
the logits and the host samples them.

At smoke width in fp32 on the CPU:

* greedy streams equal the fused path's bitwise, on both layouts (paged
  with chunked prefill and the prefix cache too) and on the hybrid family,
  and the reference's host-sampling engine's;
* stochastic streams (temperature, top-k, top-p, mixed with greedy lanes)
  equal the fused path's token for token: the host generator is seeded as
  the device's and draws at the same points, as the reference's key
  mirror does for its ablation;
* an engine builds one decode program for every sampling form without
  fused sampling (the device program does not sample), three with it;
* a non-finite logits row samples the sentinel on the host.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import registry as jreg
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import NONFINITE_TOKEN, EngineConfig, ServeEngine

MAX_LEN, BS = 48, 8
LAYOUTS = {
    "slotted": dict(max_slots=3),
    "paged": dict(max_slots=3, kv_layout="paged", page_size=BS),
    "paged_chunked_prefix": dict(max_slots=3, kv_layout="paged", page_size=BS,
                                 prefill_chunk=BS, prefix_cache=True, num_blocks=9,
                                 admission="preempt"),
    "hybrid": dict(max_slots=3),
}


@pytest.fixture(scope="module")
def archs():
    out = {}
    for arch in ("smollm-360m", "zamba2-1.2b"):
        jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
        tcfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
        jp = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0))
        out[arch] = (jcfg, jp, tcfg,
                     params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def _traffic(sampled: bool):
    """Seven staggered requests sharing a 16-token prefix; with
    ``sampled`` every other one draws (temperature, top-k and/or top-p)."""
    rng = np.random.default_rng(4)
    pre = rng.integers(0, 256, 16).astype(np.int32)
    out = []
    for i in range(7):
        tail = rng.integers(0, 256, int(rng.integers(1, 14))).astype(np.int32)
        prompt = np.concatenate([pre, tail]) if i % 2 else tail
        kw = {}
        if sampled and i % 2 == 0:
            kw = [dict(temperature=0.9), dict(temperature=0.7, top_k=12),
                  dict(temperature=1.1, top_p=0.8), dict(temperature=0.8, top_k=20,
                                                         top_p=0.9)][i // 2]
        out.append((i // 2, prompt, int(rng.integers(3, 9)), kw))
    return out


def _run(eng, traffic):
    i = tick = 0
    while i < len(traffic) or eng.has_work():
        while i < len(traffic) and traffic[i][0] <= tick:
            _, prompt, budget, kw = traffic[i]
            eng.submit(prompt, max_new_tokens=budget, rid=i, **kw)
            i += 1
        eng.step()
        eng.check_invariants()
        tick += 1
        assert tick < 500
    return [list(eng.completions[r].tokens) for r in range(len(traffic))]


def _engine(archs, layout, fused, seed=3):
    _, _, tcfg, tp = archs["zamba2-1.2b" if layout == "hybrid" else "smollm-360m"]
    return ServeEngine(tcfg, tp, EngineConfig(max_len=MAX_LEN, seed=seed, fused_sampling=fused,
                                              **LAYOUTS[layout]), device="cpu")


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "stochastic"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_host_sampling_matches_fused(archs, layout, sampled):
    traffic = _traffic(sampled)
    fused = _engine(archs, layout, True)
    host = _engine(archs, layout, False)
    want = _run(fused, traffic)
    assert _run(host, traffic) == want
    for k in ("prefills", "prefill_chunks", "decode_steps", "preemptions",
              "prefix_hit_tokens"):
        assert host.counters[k] == fused.counters[k], k
    if sampled:
        # the draws matter: another seed samples other tokens
        assert _run(_engine(archs, layout, False, seed=4), traffic) != want
    if layout == "paged_chunked_prefix":
        c = host.counters
        assert c["prefill_chunks"] > c["prefills"] and c["prefix_hit_tokens"] > 0


def test_host_sampling_greedy_matches_reference(archs, mesh, rules):
    """Greedy with host sampling in both packages, on the same traffic:
    the same streams."""
    jcfg, jp, _, _ = archs["smollm-360m"]
    traffic = _traffic(False)
    ref = JServeEngine(jcfg, mesh, rules, jp, JEngineConfig(
        max_len=MAX_LEN, fused_sampling=False, **LAYOUTS["paged"]))
    assert _run(_engine(archs, "paged", False), traffic) == _run(ref, traffic)


@pytest.mark.parametrize("fused", [True, False])
def test_one_decode_program_per_sampling_form(archs, fused):
    """Without fused sampling one decode program serves greedy, sampled
    and masked traffic; with it, one program per form.  ``prebuild``
    covers them and builds stay flat."""
    eng = _engine(archs, "paged", fused)
    eng.prebuild()
    built = eng.stats["builds"]
    _run(eng, _traffic(True))
    assert eng.stats["builds"] == built
    decodes = [k for k in eng.aot.keys() if k[0] == "slot_decode"]
    assert len(decodes) == (3 if fused else 1)
    assert {k[1:3] for k in decodes} == ({(False, False), (True, False), (True, True)}
                                         if fused else {(False, False)})


def test_host_sampler_flags_nonfinite(archs):
    eng = _engine(archs, "slotted", False)
    logits = torch.zeros(3, 7)
    logits[0, 4] = 1.0
    logits[1, 2] = float("nan")
    logits[2, 5] = float("inf")
    toks = eng._host_sample(logits, [0.0, 0.0, 0.5], [0, 0, 0], [0.0, 0.0, 0.0],
                            stochastic=True, masked=False)
    assert toks.tolist() == [4, NONFINITE_TOKEN, NONFINITE_TOKEN]
