"""Multi-device massive-graph generation with checkpoint/restart, on the
PyTorch/CUDA port: the counterpart of ``examples/generate_massive.py``.

A thin wrapper over ``repro_torch.launch.generate`` (same flags, plus
``--device``):

    PYTHONPATH=src python examples/torch_generate_massive.py --preset paper_smoke
    PYTHONPATH=src python examples/torch_generate_massive.py --device cpu \\
        --procs 8 --vertices-per-proc 20000 --ckpt /tmp/gen_ckpt.json
    torchrun --nproc_per_node=4 examples/torch_generate_massive.py \\
        --preset paper_1b_5b
"""
from __future__ import annotations

import sys

from repro_torch.launch.generate import main

if __name__ == "__main__":
    sys.exit(main())
