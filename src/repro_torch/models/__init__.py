"""Model substrate: the decoder stacks of every family the JAX package's
``models/`` serves (dense and vision GQA, MoE, MLA, Mamba-2 SSD, RG-LRU
hybrids, the encoder-decoder)."""
from repro_torch.models.model import Model, build_model
