"""Per-architecture configs (assigned pool) + shape registry: a copy of
the JAX package's ``configs/``, which is plain data."""
from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, applicable_shapes
from repro_torch.configs.registry import ARCH_IDS, get_config, all_configs
