"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=5632, vocab_size=100352, head_dim=64,
    attention="gqa", mlp="swiglu", norm="layernorm", rope_theta=10000.0,
)
