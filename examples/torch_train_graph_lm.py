"""End to end on the PyTorch/CUDA port: generate a scale-free
graph -> random-walk corpus -> train an LM on it (the counterpart of
``examples/train_graph_lm.py``).

    PYTHONPATH=src python examples/torch_train_graph_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_graph_lm.py --device cpu \\
        --steps 20 --batch 4 --seq 32

The JAX example's flags and presets (``tiny``: a reduced qwen1.5-family
model; ``100m``: 16 layers x 768) plus ``--device``, over the training
launcher's loop (``launch/train.py::train``): the PBA walk corpus of
vocab-size vertices generated by the port, float32 masters drawn by
``convert.numpy_params(model, 0)``, AdamW with 50 warm-up steps,
gradient accumulation, a checkpoint every ``--ckpt-every`` steps and a
restart from the newest (the walk corpus's cursor restored), a loss
line every 20 steps. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.train import train


def make_cfg(preset: str):
    base = get_config("qwen1.5-0.5b")
    if preset == "tiny":
        cfg = dataclasses.replace(base.reduced(), vocab_size=4096,
                                  num_layers=4, d_model=256, d_ff=768,
                                  num_heads=8, num_kv_heads=8, head_dim=32)
    elif preset == "100m":
        # ~100M params: 16L x 768d, vocab 8192
        cfg = dataclasses.replace(base, num_layers=16, d_model=768,
                                  num_heads=12, num_kv_heads=12, head_dim=64,
                                  d_ff=2048, vocab_size=8192,
                                  tie_embeddings=True)
    else:
        raise ValueError(preset)
    return cfg


def main(argv=None) -> list:
    """Run the example; returns the (step, loss) pairs it printed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cuda (default, raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = make_cfg(args.preset)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 accum=args.accum, lr=args.lr, warmup_steps=50,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 device=args.device, corpus_vertices=cfg.vocab_size,
                 log_every=20)


if __name__ == "__main__":
    main()
