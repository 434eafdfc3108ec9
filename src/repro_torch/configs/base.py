"""Model and hardware configs: the port's own copy of
``repro.configs.base.ModelConfig``, ``ConvLayerSpec``, ``CNNConfig``,
``DNNConfig``, ``InputShape`` and ``INPUT_SHAPES``, ``HardwareConfig``
(with the reference's four platforms) and the block-kind constants, field for field (the two packages share no code,
so a config object of one is rebuilt in the other from
``dataclasses.asdict``), plus the port's own ``H100_SXM`` and
``H100_SXM_BF16`` entries."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds understood by models/transformer.py
# ---------------------------------------------------------------------------
ATTN_GLOBAL = "global"        # full causal attention
ATTN_LOCAL = "local"          # sliding-window causal attention
BLOCK_MAMBA = "mamba"         # Mamba2 (SSD) block
BLOCK_SHARED_ATTN = "shared_attn"  # zamba2-style shared attention+MLP block
BLOCK_MLSTM = "mlstm"         # xLSTM matrix-LSTM block
BLOCK_SLSTM = "slstm"         # xLSTM scalar-LSTM block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | hybrid | ssm | audio
    source: str                      # citation for the config numbers

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- attention ---
    block_pattern: Tuple[str, ...] = (ATTN_GLOBAL,)
    pattern_repeats: int = 0
    sliding_window: int = 4096       # window for ATTN_LOCAL blocks
    attn_logit_softcap: float = 0.0  # gemma2: 50.0
    final_logit_softcap: float = 0.0 # gemma2: 30.0
    rope_theta: float = 10000.0
    mrope: bool = False              # qwen2-vl M-RoPE (3 rotary sections)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    qk_norm: bool = False

    # --- mlp ---
    mlp_kind: str = "swiglu"         # swiglu | geglu | gelu
    tie_embeddings: bool = True

    # --- moe ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0                # per-expert hidden size
    num_shared_experts: int = 0
    shared_expert_d_ff: int = 0
    router_aux_loss_coef: float = 0.001
    moe_capacity_factor: float = 1.25
    moe_expert_pad: int = 0
    moe_down_rs: bool = False
    loss_chunk: int = 0
    seq_shard_carry: bool = False

    # --- ssm / hybrid ---
    ssm_state: int = 0               # mamba2 state dim per head
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4

    # --- modality frontends ---
    frontend: Optional[str] = None   # None | "vision" | "audio"
    num_codebooks: int = 0           # musicgen
    vision_tokens: int = 1024

    # --- numerics ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"

    # --- distribution ---
    fsdp: bool = False
    long_context_window: int = 4096  # SWA window substituted at long_500k decode
    remat: str = "none"

    def __post_init__(self):
        if self.pattern_repeats == 0 and self.num_layers:
            object.__setattr__(
                self, "pattern_repeats", self.num_layers // len(self.block_pattern))
        if self.num_layers and (
                self.num_layers != self.pattern_repeats * len(self.block_pattern)):
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} is not "
                f"pattern_repeats x len({self.block_pattern})")
        if self.num_heads and self.num_kv_heads and (
                self.num_heads % self.num_kv_heads):
            raise ValueError(
                f"{self.name}: num_heads must be a multiple of num_kv_heads")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self, active_only: bool = False) -> int:
        """The reference's closed-form parameter count
        (``repro.configs.base.ModelConfig.param_count``), term for term:
        ``launch.dryrun.model_flops`` reads it."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        n_mats = {"swiglu": 3, "geglu": 3, "gelu": 2}[self.mlp_kind]
        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d
        for kind in self.block_pattern:
            if kind in (ATTN_GLOBAL, ATTN_LOCAL, BLOCK_SHARED_ATTN):
                attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                mlp = n_mats * d * ff if ff else 0
                total += (attn + mlp) * self.pattern_repeats
            elif kind == BLOCK_MAMBA:
                din = self.ssm_expand * d
                # in_proj (x, z, B, C, dt) + out_proj + conv
                nh = self.ssm_heads or max(1, din // 64)
                blk = d * (2 * din + 2 * self.ssm_state + nh) + din * d
                blk += self.ssm_conv_width * (din + 2 * self.ssm_state)
                total += blk * self.pattern_repeats
            elif kind in (BLOCK_MLSTM, BLOCK_SLSTM):
                dp = self.ssm_expand * d if kind == BLOCK_MLSTM else d
                blk = 4 * d * dp + dp * d
                total += blk * self.pattern_repeats
        if self.num_experts:
            # routed experts (+ router) and shared experts on every attn
            # block; the dense d_ff path is absent for MoE blocks
            n_moe_blocks = sum(
                1 for k in self.block_pattern if k in (ATTN_GLOBAL, ATTN_LOCAL)
            ) * self.pattern_repeats
            per_expert = 3 * self.d_model * self.moe_d_ff
            routed = self.num_experts * per_expert
            shared = 3 * self.d_model * self.shared_expert_d_ff
            router = self.d_model * self.num_experts
            total += n_moe_blocks * (routed + shared + router)
            total -= n_moe_blocks * (n_mats * self.d_model * self.d_ff
                                     if self.d_ff else 0)
            if active_only:
                total -= n_moe_blocks * (self.num_experts
                                         - self.num_experts_per_tok
                                         ) * per_expert
        return total

    def replace(self, **kw) -> "ModelConfig":
        if "block_pattern" in kw or "num_layers" in kw:
            kw.setdefault("pattern_repeats", 0)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ConvLayerSpec:
    """One layer of a paper CNN (VGG-A / OverFeat-FAST), for models/cnn.py."""
    kind: str          # conv | pool | fc
    ifm: int = 0
    ofm: int = 0
    kernel: int = 0
    stride: int = 1
    pad: int = 0
    out_hw: int = 0    # output feature-map spatial size (square)


@dataclass(frozen=True)
class CNNConfig:
    name: str
    source: str
    layers: Tuple[ConvLayerSpec, ...]
    image_size: int
    num_classes: int = 1000
    family: str = "cnn"

    def conv_layers(self):
        return [lyr for lyr in self.layers if lyr.kind == "conv"]

    def fc_layers(self):
        return [lyr for lyr in self.layers if lyr.kind == "fc"]


@dataclass(frozen=True)
class DNNConfig:
    """Fully-connected ASR net (paper §5.4 CD-DNN)."""
    name: str
    source: str
    input_dim: int
    hidden_dim: int
    num_hidden: int
    output_dim: int
    family: str = "dnn"


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Hardware models (the paper's platforms, the reference's TPU target, and
# the port's card)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class HardwareConfig:
    name: str
    peak_flops: float          # per chip/node, FLOP/s
    mem_bw: float              # bytes/s HBM or DRAM
    link_bw: float             # bytes/s network/ICI per direction
    sw_latency: float = 5e-6   # per-message software overhead (paper's SWlat)
    cache_bytes: int = 0       # on-chip capacity used by the blocking solver


TPU_V5E = HardwareConfig(
    name="tpu-v5e",
    peak_flops=197e12,         # bf16
    mem_bw=819e9,
    link_bw=50e9,              # per ICI link
    cache_bytes=16 * 2**20,    # ~16 MiB VMEM usable half for double buffering
)

# Paper platforms (Table 1 / §5):
XEON_E5_2698V3_FDR = HardwareConfig(
    # 2s16c HSW 2.3GHz: 2 sockets * 16 cores * 32 flops/cycle(FMA AVX2 SP) * 2.3e9
    name="2s16c-E5-2698v3+FDR",
    peak_flops=2 * 16 * 32 * 2.3e9,   # ~2.36 TF SP
    mem_bw=136e9,
    # 56 Gbps FDR = 7 GB/s: 2355 GF / 7 GB/s = 336, the paper's Table-1
    # comp-to-comms ratio
    link_bw=56e9 / 8,
    cache_bytes=128 * 1024,           # per-thread budget used in the paper
)
XEON_E5_2666V3_10GBE = HardwareConfig(
    name="2s9c-E5-2666v3+10GbE",
    peak_flops=2 * 9 * 32 * 2.9e9,    # ~1.67 TF SP
    mem_bw=136e9,
    # 10 GbE = 1.25 GB/s: 1670 GF / 1.25 GB/s = 1336, the paper's Table-1 value
    link_bw=10e9 / 8,
    cache_bytes=128 * 1024,
)
XEON_E5_2697V3 = HardwareConfig(
    name="2s14c-E5-2697v3",
    peak_flops=1.7e12,                # paper: 1.7 TFLOPS/s SP peak
    mem_bw=136e9,
    link_bw=56e9 / 8 * 0.9,
    cache_bytes=128 * 1024,
)

#: One NVIDIA H100 SXM, the port's card.  Data-sheet figures (NVIDIA's H100
#: data sheet and Hopper white paper), not measurements: ``peak_flops`` is
#: f32 outside the tensor cores, the precision the port's FFMA kernels
#: compute in; ``link_bw`` is NVLink's 450 GB/s each way; ``cache_bytes``
#: is the shared memory one block can use, the budget of the §2.2 GEMM
#: blocking preset (``core.blocking.solve_h100_gemm_blocking``).  The
#: bounds ``chip_smoke.py`` prints are computed from these.
H100_SXM = HardwareConfig(
    name="h100-sxm",
    peak_flops=67e12,
    mem_bw=3.35e12,
    link_bw=450e9,
    cache_bytes=232_448,
)

#: The same card for the LMs' bf16 products on the tensor cores (data
#: sheet: H100 SXM5 at 700 W, 989.4e12 FLOP/s dense bf16).  The port's dry
#: run (``launch.dryrun``) and roofline (``core.roofline``) divide by this
#: entry's peak, its HBM rate and its NVLink rate; ``TPU_V5E`` stays only
#: for the parity tests of ``core.hybrid.plan``.
H100_SXM_BF16 = HardwareConfig(
    name="h100-sxm-bf16",
    peak_flops=989.4e12,
    mem_bw=3.35e12,
    link_bw=450e9,
    cache_bytes=232_448,
)
