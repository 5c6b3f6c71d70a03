"""Sharding rules and the activation-sharding context (the JAX package's
``sharding/``): logical axes to mesh axes, for parameters, activations,
caches and batches."""
from repro_torch.sharding.ctx import (constrain, current_mesh, current_rules,
                                      sharding_ctx)
from repro_torch.sharding.rules import (TP_AXES, PartitionSpec, Rules,
                                        make_rules, mesh_axis_size)
