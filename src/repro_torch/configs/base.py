"""Architecture configuration schema + the assigned input-shape sets.

A copy of the reference's ``configs/base.py`` (stdlib only).  One
``<arch>.py`` per ported architecture lives next to this module; each
exports ``CONFIG`` (the exact published configuration) and ``SMOKE`` (a
reduced same-family configuration for CPU smoke tests).  Architectures
arrive here with their families; ``ARCH_IDS`` lists those ported so far.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = (
    "smollm-360m",
    "zamba2-1.2b",
    "gemma2-27b",
    "deepseek-67b",
    "stablelm-12b",
    "qwen3-moe-30b-a3b",
    "qwen3-moe-235b-a22b",
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_expert: int = 0          # per-expert FFN hidden dim
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 0             # N, SSM state size
    head_dim: int = 64         # P, channels per SSD head
    expand: int = 2            # d_inner = expand * d_model
    n_groups: int = 1          # B/C parameter groups
    conv_kernel: int = 4
    chunk: int = 256           # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0            # 0 -> d_model // n_heads

    # attention features
    window: int = 0            # >0: sliding-window size for local layers
    alt_local_global: bool = False   # gemma2: even layers local, odd global
    attn_softcap: float = 0.0        # gemma2 attention-logit softcap
    logit_softcap: float = 0.0       # gemma2 final-logit softcap
    rope_theta: float = 10_000.0
    qk_norm: bool = False            # qwen3 QK-RMSNorm
    query_scale: float = 0.0         # 0 -> head_dim**-0.5 (gemma2 overrides)
    gate_act: str = "silu"           # ffn gate activation ("silu" | "gelu")
    # "chunked": plain PyTorch everywhere (chunked attention, ssd_chunked,
    # rms_norm); "kernel": the hand-written CUDA kernels of the family's
    # path (flash prefill attention; for hybrid also the SSD scan and the
    # RMSNorm kernels)
    attn_impl: str = "chunked"

    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()

    # hybrid / xlstm block layout
    attn_every: int = 0        # zamba2: shared attn block every k SSM layers
    slstm_every: int = 0       # xlstm: one sLSTM per k blocks (rest mLSTM)

    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 0           # encoder frame count (stubbed frontend)

    # modality frontend stubs (vlm/audio): precomputed embeddings
    frontend_tokens: int = 0   # image patch tokens prepended to the sequence
    frontend_dim: int = 0      # stub embedding dim (projected to d_model)

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # set True if the arch supports O(seq) decode (SSM/hybrid/linear-attn)
    subquadratic: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def n_params_dense(self) -> int:
        """Approximate parameter count (for 6ND model-FLOPs accounting)."""
        d, f, v, h = self.d_model, self.d_ff, self.vocab, self.head_dim
        attn = d * h * (self.n_heads + 2 * self.n_kv) + self.n_heads * h * d
        ffn = 3 * d * f if f else 0
        if self.moe.num_experts:
            ffn = 3 * d * self.moe.d_expert * self.moe.num_experts
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn) + emb

    @property
    def n_params_active(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.moe.num_experts:
            return self.n_params_dense
        d, v = self.d_model, self.vocab
        h = self.head_dim
        attn = d * h * (self.n_heads + 2 * self.n_kv) + self.n_heads * h * d
        ffn = 3 * d * self.moe.d_expert * self.moe.top_k
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn) + emb


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a shape cell runs for this arch."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention; skipped for full-attention archs"
    return True, ""


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.SMOKE
