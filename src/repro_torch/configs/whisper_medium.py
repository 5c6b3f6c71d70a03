"""Whisper-medium [arXiv:2212.04356; unverified] — enc-dec audio backbone.

Conv frontend STUBBED per assignment: input_specs() provides precomputed
frame embeddings (B, 1500, d_model). Shape seq_len applies to the decoder.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865, head_dim=64,
    attention="gqa", mlp="gelu", norm="layernorm",
    encoder_layers=24, encoder_len=1500,
)
