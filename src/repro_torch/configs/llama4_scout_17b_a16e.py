"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

MoE 16 experts top-1 + shared expert; iRoPE: chunked attention on 3 of 4
layers, global on the 4th. Early-fusion vision path stubbed (text backbone).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    attention="gqa", mlp="swiglu", norm="rmsnorm", rope_theta=500000.0,
    layer_pattern=("chunked", "chunked", "chunked", "global"),
    chunk_size=8192,
    moe=True, num_experts=16, top_k=1, moe_d_ff=8192,
    shared_expert_d_ff=8192,
)
