"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B; hf] — dense, QKV bias, full MHA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=2816, vocab_size=151936, head_dim=64,
    attention="gqa", qkv_bias=True, mlp="swiglu", norm="rmsnorm",
    rope_theta=1e6, tie_embeddings=True,
)
