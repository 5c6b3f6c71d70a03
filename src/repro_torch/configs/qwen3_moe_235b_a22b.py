"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf] — 128e top-8."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128,
    attention="gqa", mlp="swiglu", norm="rmsnorm", rope_theta=1e6,
    moe=True, num_experts=128, top_k=8, moe_d_ff=1536,
)
