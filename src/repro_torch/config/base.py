"""The LM stack's configuration dataclasses.

A copy of ``repro/config/base.py``'s model configs (that module cannot be
imported here: its package loads JAX), with ``torch`` dtypes in place of
``jnp`` ones. ``AttentionConfig``, ``MoEConfig``, ``SSMConfig``,
``RGLRUConfig``, ``EncoderConfig`` (whisper's encoder tower),
``CrossAttnConfig`` (the vlm's gated cross layers) and ``ModelConfig``
drive the port's models; ``InputShape`` and ``INPUT_SHAPES`` are the
four workload shapes, and ``MeshConfig``, ``TrainConfig``, ``ServeConfig``
and ``RunConfig`` the run settings, field for field the reference's.
``MoEConfig.sharding`` and ``combine`` are the
reference's mesh settings; on one device only the gather combine runs,
as in the reference, and under a mesh ``models/moe.py``'s per-rank body
takes the reduce combine where the reference's rule does.

One meaning differs: ``attn_impl``'s default is ``"flash"``, the flash
kernel (#8, ``kernels/flash_attention.py``): on CUDA tensors it runs the
hand-written kernel, on CPU tensors its plain version. It is forward only,
as the reference's Pallas kernel is, so training (``launch/train.py``)
sets the reference's default ``"chunked"`` (query chunks over the plain
grouped attention, differentiable). ``"xla"`` is the plain grouped
attention of ``models/attention.py`` and ``"banded"`` its static band of
query blocks (as the reference's); the reference's ``"pallas"`` converts
to ``"flash"``. ``GossipConfig`` is the gossip optimizer's
(``core/gossip_optimizer.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True
    sliding_window: Optional[int] = None   # None = full attention
    causal: bool = True

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    sharding: str = "expert"
    dispatch_groups: int = 1
    combine: str = "gather"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    d_conv: int = 4
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0
    d_conv: int = 4
    num_heads: int = 0
    c: float = 8.0
    local_window: int = 2048


@dataclass(frozen=True)
class EncoderConfig:
    num_layers: int
    source_len: int
    d_model: int = 0
    causal: bool = False


@dataclass(frozen=True)
class CrossAttnConfig:
    every_n_layers: int
    source_len: int
    gated: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    cross_attn: Optional[CrossAttnConfig] = None
    # repeating layer pattern, tiled to num_layers (remainder layers take
    # the pattern prefix): 'attn', 'local', 'rglru', 'ssm', 'cross'
    layer_pattern: Tuple[str, ...] = ("attn",)
    norm_eps: float = 1e-6
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    tie_embeddings: bool = False
    act: str = "swiglu"               # swiglu | gelu
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    max_target_positions: int = 0     # 0 = unbounded (rope)
    # the reference's training switches; serving has no use for them
    remat: bool = True
    scan_layers: bool = True
    citation: str = ""
    # 'flash' (kernel #8), 'chunked' (query chunks, differentiable),
    # 'banded' (static query blocks over their window's keys) or 'xla'
    # (plain grouped attention)
    attn_impl: str = "flash"
    attn_chunk: int = 512
    xent_chunk: int = 512

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def layer_kinds(self) -> Tuple[str, ...]:
        p = self.layer_pattern
        reps, rem = divmod(self.num_layers, len(p))
        return p * reps + p[:rem]

    def param_count(self) -> int:
        """Total parameter count (embedding, layers and head)."""
        from repro_torch.models.layers import spec_param_count
        from repro_torch.models.transformer import model_spec
        return spec_param_count(model_spec(self))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only the top-k experts
        count). The reference's arithmetic, its override of the MoE layer
        count included: every layer counts as a MoE layer."""
        total = self.param_count()
        if self.moe is None:
            return total
        m = self.moe
        # per-expert FFN parameters (3 matrices for swiglu, 2 for gelu)
        nmat = 3 if self.act == "swiglu" else 2
        per_expert = nmat * self.d_model * m.d_ff_expert
        n_moe_layers = self.num_layers
        inactive = (m.num_experts - m.top_k) * per_expert * n_moe_layers
        return total - inactive


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    """The reference's device mesh (data x model, times pods). The port's
    meshes are ``DeviceMesh``es of ranks (``launch.mesh.make_mesh``); the
    production mesh is one over a fake process group
    (``launch.mesh.make_production_mesh``)."""

    data: int = 16
    model: int = 16
    pods: int = 1

    @property
    def multi_pod(self) -> bool:
        return self.pods > 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.pods


@dataclass(frozen=True)
class GossipConfig:
    """Gossip optimizer settings (the paper's protocol between replicas)."""

    enabled: bool = True
    schedule: str = "hypercube"    # hypercube | ring | random
    merge: str = "mu"              # mu | um | rw  (rw = no merge: plain local SGD)
    pod_every: int = 8             # gossip across the pod axis every K steps
    seed: int = 0
    # wire codec of the exchanged model ("" = the parameter dtype; "bf16"
    # halves the wire, averaging still in f32)
    exchange_dtype: str = ""


@dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 1024
    global_batch: int = 32
    steps: int = 100
    learning_rate: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    optimizer: str = "adamw"       # adamw | sgdm | pegasos
    grad_clip: float = 1.0
    seed: int = 0
    log_every: int = 10
    eval_every: int = 0
    checkpoint_every: int = 0
    checkpoint_dir: str = ""


@dataclass(frozen=True)
class ServeConfig:
    max_seq_len: int = 4096
    batch_size: int = 8
    prefill_len: int = 512
    decode_steps: int = 64
    window: Optional[int] = None   # windowed KV cache (ring buffer) if set


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    gossip: GossipConfig = field(default_factory=GossipConfig)
