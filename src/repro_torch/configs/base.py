"""Configuration dataclasses (the port's own copy of
``repro.configs.base``'s ``ModelConfig``, ``MoEConfig``, ``RWKVConfig``,
``HybridConfig``, ``ShapeConfig`` with its ``SHAPES``,
``PodRefreshConfig`` and ``MeshConfig`` with its ``MESHES``, restricted
to what the port runs).

One ``ModelConfig`` per architecture lives in
``repro_torch/configs/<arch_id>.py``; each exposes ``config()`` (full
size) and ``smoke_config()`` (reduced: 2 layers, narrow widths, <= 4
experts, runnable on a CPU). The port runs the dense decoder, MoE, RWKV
and hybrid (griffin) families; the reference's remat field, which serves
its dry-run, is absent.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    aux_loss_weight: float = 0.01
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    lora_rank_decay: int = 64  # low-rank size for data-dependent decay
    lora_rank_mix: int = 32  # low-rank size for ddlerp token-shift
    chunk_size: int = 128  # chunkwise-parallel scan chunk


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    # RecurrentGemma-style: repeating block pattern, e.g. ("rec","rec","attn")
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    lru_width: Optional[int] = None  # defaults to d_model
    conv_width: int = 4
    attn_window: int = 2048


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | rwkv | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # set -> sliding-window attention
    # norms
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # modality: number of stub frontend embedding positions that replace
    # the first token positions (audio frames / vision patches). 0 for
    # text-only.
    n_prefix_embeddings: int = 0
    moe: Optional[MoEConfig] = None
    rwkv: Optional[RWKVConfig] = None
    hybrid: Optional[HybridConfig] = None
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    source: str = ""  # citation

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class PodRefreshConfig:
    """Cadence and targets of the LIVE pod-k refresh (the two-level
    bucketed sync only): every ``every`` steps the train driver measures
    each bucket's realized mass capture on the live memory + gradient
    buffers again and feeds the new per-bucket pod ks into the same step
    (the k-padded wire of ``SyncConfig.pod_dynamic`` keeps every shape)."""

    every: int = 0  # steps between re-calibrations (0 = off)
    # mass-capture target for refreshes (None: SyncConfig.pod_mass_target)
    mass_target: Optional[float] = None
    # cross-pod bytes/step/worker each refresh water-fills
    # (core.budget.BudgetController) instead of sizing for the mass
    # target (None: SyncConfig.byte_budget; both None: the mass target)
    byte_budget: Optional[int] = None
    # cap on the static padded pod k as a fraction of bucket cols (None:
    # the n_data * k_row support bound)
    k_max_ratio: Optional[float] = None

    @property
    def enabled(self) -> bool:
        return self.every > 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """One named worker layout. ``n_pods > 1`` declares a (pod, data)
    layout: the two-level hierarchical sync re-compresses at the pod
    boundary and the batch splits over both. ``n_model`` is the
    reference's tensor-parallel axis, which the port does not run
    (``launch.mesh.mesh_from_config`` raises for n_model > 1)."""

    name: str
    n_pods: int
    n_data: int
    n_model: int = 1


MESHES = {
    # smoke layouts of 8 workers: the two-level pod sync's test layout
    "smoke_1pod": MeshConfig("smoke_1pod", 1, 8, 1),
    "smoke_2pod": MeshConfig("smoke_2pod", 2, 4, 1),
    # production pods: 16 x 16 per pod, 2 pods across the slow link
    "pod_256": MeshConfig("pod_256", 1, 16, 16),
    "pod_2x256": MeshConfig("pod_2x256", 2, 16, 16),
}
