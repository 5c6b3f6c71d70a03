"""Phi-3-vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct; hf].

Phi3-mini text backbone + CLIP frontend STUBBED: input_specs() provides
precomputed patch embeddings replacing the first num_patches positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    attention="gqa", mlp="swiglu", norm="rmsnorm", rope_theta=10000.0,
    num_patches=256,
)
