"""One gloo rank of tests/test_torch_train.py's dp_sync check, in a module
that imports neither JAX nor the test module (each spawned rank imports
this module alone). It holds no test of its own."""
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train import compress


def dp_inputs(world: int):
    """Two steps of per-rank gradient trees, stacked (world, ...)."""
    rng = np.random.default_rng(7 + world)
    return [{"w": rng.normal(size=(world, 33, 5)).astype(np.float32),
             "b": [rng.normal(size=(world, 7)).astype(np.float32) * 1e-3]}
            for _ in range(2)]


def rank_main(rank, world, init_file, out):
    """Two dp_sync calls (the second carrying the first's error) on this
    rank's slice of dp_inputs; the reduced means and error buffers saved
    as ``rank{rank}.npz`` under ``out``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        res, err = {}, None
        for i, g in enumerate(dp_inputs(world)):
            mine = tree_map(lambda _, a: torch.from_numpy(a[rank]), g)
            red, err = compress.dp_sync(mine, err)
            for name, tree in (("red", red), ("err", err)):
                for j, leaf in enumerate(tree_leaves(tree)):
                    res[f"{world}_{i}_{name}_{j}"] = leaf.numpy()
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()
