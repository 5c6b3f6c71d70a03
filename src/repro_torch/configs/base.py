"""Architecture + shape configuration system.

A copy of the JAX package's ``configs/base.py`` (plain Python data, so the
port keeps its own copy instead of importing it). Every assigned
architecture is an ``ArchConfig`` (one module per arch under
repro_torch/configs/); shapes are the four assigned input-shape cells.
``reduced()`` returns a small same-family config for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | audio | ssm | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # attention flavor
    attention: str = "gqa"           # gqa | mla | none
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    local_window: int = 0            # sliding-window size for "local" layers
    chunk_size: int = 0              # chunked-attention size for "chunked"
    layer_pattern: tuple[str, ...] = ("global",)
    # per-layer kinds, tiled over num_layers. kinds:
    #   global  - full causal attention
    #   local   - sliding-window attention
    #   chunked - chunk-local causal attention (llama4 iRoPE style)
    #   rec     - RG-LRU recurrent block
    #   ssm     - Mamba-2 SSD block

    # mlp
    mlp: str = "swiglu"              # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False

    # MoE
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25

    # MLA dims (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_d_inner: int = 0             # 0 -> expand * d_model (set for TP padding)

    # RG-LRU (recurrentgemma)
    rglru_width: int = 0             # recurrent width (defaults to d_model)
    rglru_conv: int = 4

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_len: int = 0             # fixed encoder context (frames)

    # VLM (phi-3-vision)
    num_patches: int = 0

    max_seq_len: int = 524288

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.rglru_width == 0 and "rec" in self.layer_pattern:
            object.__setattr__(self, "rglru_width", self.d_model)

    @property
    def is_subquadratic(self) -> bool:
        """True if no layer needs an unbounded full-attention KV cache."""
        return all(k in ("rec", "ssm", "local", "chunked")
                   for k in self.layer_pattern)

    @property
    def has_decoder(self) -> bool:
        return True  # no encoder-only archs in the assigned pool

    def layer_kinds(self) -> tuple[str, ...]:
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        changes = dict(
            num_layers=max(2, 2 * len(self.layer_pattern)),
            d_model=128,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=max(1, min(self.num_kv_heads, 4)) if self.num_heads
            else 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
            max_seq_len=512,
        )
        if self.moe:
            changes.update(num_experts=4, top_k=min(self.top_k, 2),
                           moe_d_ff=64, capacity_factor=4.0,
                           shared_expert_d_ff=64 if self.shared_expert_d_ff else 0)
        if self.attention == "mla":
            changes.update(q_lora_rank=64, kv_lora_rank=32, qk_rope_dim=16,
                           qk_nope_dim=16, v_head_dim=32, head_dim=32)
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32,
                           ssm_d_inner=0)
        if self.rglru_width:
            changes.update(rglru_width=128)
        if self.local_window:
            changes.update(local_window=64)
        if self.chunk_size:
            changes.update(chunk_size=64)
        if self.encoder_layers:
            changes.update(encoder_layers=2, encoder_len=64)
        if self.num_patches:
            changes.update(num_patches=16)
        return dataclasses.replace(self, **changes)

    def num_params(self) -> int:
        """Analytic parameter count (embedding + per-layer), for 6ND."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # output head
        kinds = self.layer_kinds()
        for kind in kinds:
            total += 2 * d  # pre-norms (attn/mixer + mlp)
            if kind in ("global", "local", "chunked"):
                if self.attention == "mla":
                    total += d * self.q_lora_rank
                    total += self.q_lora_rank * self.num_heads * (
                        self.qk_rope_dim + self.qk_nope_dim)
                    total += d * (self.kv_lora_rank + self.qk_rope_dim)
                    total += self.kv_lora_rank * self.num_heads * (
                        self.qk_nope_dim + self.v_head_dim)
                    total += self.num_heads * self.v_head_dim * d
                else:
                    hd = self.head_dim
                    total += d * self.num_heads * hd           # Wq
                    total += 2 * d * self.num_kv_heads * hd    # Wk, Wv
                    total += self.num_heads * hd * d           # Wo
                    if self.qkv_bias:
                        total += (self.num_heads + 2 * self.num_kv_heads) * hd
            elif kind == "rec":
                w = self.rglru_width
                total += 2 * d * w + w * d      # in-proj x, gate branch, out
                total += self.rglru_conv * w    # conv
                total += 3 * w                  # lru gates (a, input gate, Λ)
            elif kind == "ssm":
                di = self.ssm_expand * d
                nh = di // self.ssm_headdim
                total += d * (2 * di + 2 * self.ssm_state + nh)  # in_proj
                total += self.ssm_conv * (di + 2 * self.ssm_state)
                total += nh * 2 + di            # A_log, D, norm
                total += di * d                 # out proj
            # mlp
            if self.moe:
                e_ff = self.moe_d_ff or self.d_ff
                total += d * self.num_experts   # router
                total += self.num_experts * 3 * d * e_ff
                if self.shared_expert_d_ff:
                    total += 3 * d * self.shared_expert_d_ff
            else:
                mult = 3 if self.mlp == "swiglu" else 2
                total += mult * d * self.d_ff
        # encoder stack (whisper)
        for _ in range(self.encoder_layers):
            hd = self.head_dim
            total += 2 * self.d_model
            total += (d * self.num_heads * hd) * 2 + 2 * d * self.num_kv_heads * hd
            total += (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
            # cross-attention in decoder counted here approximately
        return total

    def num_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.moe:
            return self.num_params()
        e_ff = self.moe_d_ff or self.d_ff
        inactive = (self.num_experts - self.top_k) * 3 * self.d_model * e_ff
        return self.num_params() - self.num_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """Shape cells that run for this arch (DESIGN.md §5 skip rules)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_subquadratic:
        names.append("long_500k")
    return names
