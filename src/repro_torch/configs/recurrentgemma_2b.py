"""RecurrentGemma-2B [arXiv:2402.19427; hf] — RG-LRU + local attn, 1:2.

26 layers = 8 full (rec, rec, local) periods + (rec, rec) remainder.
MQA (kv=1): KV heads replicated under TP, cache sequence-sharded.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    attention="gqa", mlp="gelu", norm="rmsnorm",
    layer_pattern=("rec", "rec", "local"), local_window=2048,
    rglru_width=2560, rglru_conv=4,
)
