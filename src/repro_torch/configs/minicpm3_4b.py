"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B; hf] — MLA (multi-head latent attn).

MLA inner dims parameterized per DESIGN.md §8 (offline-unverified details).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448, head_dim=96,
    attention="mla", mlp="swiglu", norm="rmsnorm", rope_theta=10000.0,
    q_lora_rank=768, kv_lora_rank=256, qk_rope_dim=32, qk_nope_dim=64,
    v_head_dim=64,
)
