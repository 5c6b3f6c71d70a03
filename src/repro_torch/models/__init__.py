"""Model substrate: the decoder stack of the dense and vision GQA families
(the JAX package's ``models/``; the other mixers wait for ROADMAP item
15b)."""
from repro_torch.models.model import Model, build_model
