"""Batched serving entry points, the port of the reference's
``serve/loop.py``.

``generate`` is a thin wrapper over the continuous-batching
:class:`~repro_torch.serve.engine.ServeEngine`: every prompt is submitted
at once into a ``max_slots = batch`` engine with one exact prompt bucket,
so its greedy tokens are the static loop's while it runs through the
slotted cache, fused sampling and the engine's programs.

``generate_static`` is the fixed-batch loop: one whole-batch prefill,
then every sequence decodes to the full token budget, sampling on the
logits each step.  It serves the families the engine does not (the
modality frontends: vlm patch embeddings, audio frames, passed as
``extra``) and is the baseline the engine is held against.

Both take a ``mesh`` (``launch.mesh.MeshGroup``): the engine's, or for the
static loop the serving mesh program around its prefill and decode, the
weights this rank's shards (``engine.serve_shard_layout``) and the cache
laid out by ``DecodeSharding.choose(mesh, B)``: the batch split over the
data axes where it divides (each rank prefills and decodes its rows, the
logits gathered), each lane's positions over ``model``, or the whole
batch on every rank with its positions over every rank; ``max_len``
rounded up to a multiple of the ranks the positions split over (the
rounded positions are never attended).  The ``lm`` family's dense, MoE
and vlm configs serve on a live model axis there; the others raise.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry
from .step import sample_tokens


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 16
    temperature: float = 0.0       # 0 => greedy
    seed: int = 0


def generate(cfg: ArchConfig, params, prompts, serve: ServeConfig | None = None, *,
             extra=None, device=None, mesh=None) -> np.ndarray:
    """prompts (B, S) int32 -> (B, max_new_tokens) int32 generated tokens,
    through the engine (on the card unless ``device="cpu"``), or through
    :func:`generate_static` when ``extra`` (the frontend input) is given or
    the family is not slot-served."""
    serve = serve or ServeConfig()
    if extra is not None or not registry.supports_slot_serving(cfg):
        return generate_static(cfg, params, prompts, serve, extra=extra, device=device,
                               mesh=mesh)
    from .engine import EngineConfig, ServeEngine

    prompts = np.asarray(prompts, np.int32)
    B, S = prompts.shape
    m = 1                                                # ranks a lane's positions split over
    if mesh is not None and mesh.pg is not None:
        from repro_torch.models.attention import DecodeSharding

        m = DecodeSharding.choose(mesh, B).seq_ranks
    engine = ServeEngine(cfg, params, EngineConfig(
        max_slots=B, max_len=-(-(S + serve.max_new_tokens) // m) * m, seed=serve.seed,
        # equal-length prompts: one exact bucket
        prefill_buckets=(S,)), device=device, mesh=mesh)
    out = engine.run(list(prompts), max_new_tokens=serve.max_new_tokens,
                     temperature=serve.temperature)
    return np.stack(out, axis=0)


def generate_static(cfg: ArchConfig, params, prompts, serve: ServeConfig | None = None,
                    *, extra=None, device=None, mesh=None) -> np.ndarray:
    """The static-batch loop: prefill once (``mod.prefill``, given
    ``extra`` where there is one: vlm patch embeddings (B,
    frontend_tokens, frontend_dim), audio frames (B, enc_seq, d_model)),
    then decode the whole batch to the full budget (``mod.decode_step`` at
    one shared position, from ``S`` plus the vlm's image tokens), sampling
    each step from a ``torch.Generator`` seeded with ``serve.seed`` (greedy
    at temperature 0).  Returns (B, max_new_tokens) int32."""
    serve = serve or ServeConfig()
    mod = registry.get_module(cfg)
    program, round_to = contextlib.nullcontext, 1
    if mesh is not None:
        from repro_torch.models.common import serve_program
        from repro_torch.optim.fsdp import local_shards
        from .engine import serve_shard_layout

        if cfg.family not in registry.MESH_SERVE_FAMILIES and mesh.size("model") > 1:
            raise NotImplementedError(
                f"{cfg.name}: serving on a live model axis is ported for the lm family "
                f"(dense, gemma2, moe, vlm) and the hybrid family (zamba2), not the "
                f"{cfg.family!r} family (ROADMAP.md {registry.MESH_FAMILY_ITEM})")
        if mesh.pg is not None:
            device = mesh.device
        lay = serve_shard_layout(cfg, mesh)
        if lay is not None:
            from repro_torch.models.attention import DecodeSharding

            params = local_shards(lay, params)
            dec = DecodeSharding.choose(mesh, len(prompts))
            program = lambda: serve_program(mesh, lay.gather_dims, dec)   # noqa: E731
            round_to = dec.seq_ranks
    device = resolve_device(device)
    params = mod.cast_for_compute(cfg, params, device)
    tokens = torch.as_tensor(np.asarray(prompts, np.int32), device=device)
    B, S = tokens.shape
    n_ctx = S + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    front = () if extra is None else (torch.as_tensor(extra, device=device),)
    L = -(-(n_ctx + serve.max_new_tokens) // round_to) * round_to
    with program():
        cache, logits = mod.prefill(cfg, params, tokens, *front, max_len=L)
    gen = torch.Generator(device=device).manual_seed(serve.seed)
    temps = torch.full((B,), float(serve.temperature), device=device)
    out = []
    for cur in range(n_ctx, n_ctx + serve.max_new_tokens):
        tok = sample_tokens(logits, gen, temps)
        out.append(tok)
        with program():
            logits, cache = mod.decode_step(cfg, params, cache, tok, cur)
    return torch.stack(out, dim=1).cpu().numpy()
