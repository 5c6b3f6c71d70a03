"""Mamba2-130M [arXiv:2405.21060; unverified] — SSD, attention-free."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, head_dim=0,
    attention="none", layer_pattern=("ssm",), mlp="swiglu",
    norm="rmsnorm", tie_embeddings=True,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=256,
)
