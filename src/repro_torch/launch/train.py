"""Training launcher: --arch <id>, AdamW on the walk corpus, with
checkpoint / restart.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 20 --batch 4 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --steps 50 --batch 8 --seq 128          # on the card

The port of the JAX package's ``launch/train.py``, with its flags, plus
``--device``: the config's ``reduced()`` unless ``--full-config``, a
float32 model, the PBA walk corpus of 8192 vertices (generated by the
port on the device), AdamW with 20 warm-up steps, a checkpoint every
``--ckpt-every`` steps under ``--ckpt-dir`` (default: a directory named
after the arch in the temp dir), and a restart from the newest one when
it exists: kill and rerun to see restart-exactness. :func:`train` runs
that loop for any config (``examples/torch_train_graph_lm.py`` calls it
with its presets). The weights are
``convert.numpy_params(model, seed=0)`` as float32 masters; whisper's
frames and a vision config's image embeddings are drawn each step from
``np.random.default_rng(1)``. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.runtime import spmd
from repro_torch.train.checkpoint import (latest_checkpoint, load_checkpoint,
                                          save_checkpoint)
from repro_torch.train.data import WalkCorpus, WalkCorpusConfig, batches
from repro_torch.train.optimizer import (AdamWConfig, init_opt_state,
                                         opt_state_struct)
from repro_torch.train.train_step import make_train_step


def train(cfg, *, steps: int, batch: int, seq: int, accum: int = 1,
          lr: float = 1e-3, warmup_steps: int = 20, ckpt_dir: str,
          ckpt_every: int, device=None, corpus_vertices: int = 8192,
          log_every: int = 10) -> list:
    """Train ``cfg`` for ``steps`` steps on the PBA walk corpus of
    ``corpus_vertices`` vertices, restarting from the newest checkpoint
    under ``ckpt_dir`` and saving one every ``ckpt_every`` steps; returns
    the (step, loss) pairs it printed (the first step and every
    ``log_every``-th)."""
    device = spmd.resolve_device(device)
    model = build_model(cfg, tp=1, compute_dtype=torch.float32,
                        device=device)
    print(f"[train] {cfg.name}: {model.count_params():,} params")

    corpus = WalkCorpus(WalkCorpusConfig(
        generator="pba", num_vertices=corpus_vertices,
        vocab_size=cfg.vocab_size, seed=0), device=device)
    params = model.master_params(convert.numpy_params(model, 0))
    opt = init_opt_state(params)
    start = 0
    ck = latest_checkpoint(ckpt_dir)
    if ck:
        loaded, opt, man = load_checkpoint(ck, params,
                                           opt_state_struct(params), device)
        params = model.master_params(loaded)
        corpus.restore(man["data"])
        start = man["step"]
        print(f"[train] restart from step {start}")

    step_fn = make_train_step(model, AdamWConfig(lr=lr,
                                                 warmup_steps=warmup_steps))
    it = batches(corpus, batch, seq, accum=accum)

    rng_extra = np.random.default_rng(1)
    logged = []
    t0 = time.perf_counter()
    for step in range(start, steps):
        b = next(it)
        mb = batch // accum
        if cfg.family == "audio":
            b["frames"] = rng_extra.normal(size=(
                accum, mb, cfg.encoder_len, cfg.d_model)).astype(
                np.float32)
        if cfg.num_patches:
            b["image_embeds"] = rng_extra.normal(size=(
                accum, mb, cfg.num_patches, cfg.d_model)).astype(
                np.float32)
        params, opt, m = step_fn(params, opt, b)
        if (step + 1) % log_every == 0 or step == start:
            loss = float(m["loss"])
            logged.append((step + 1, loss))
            rate = (step + 1 - start) * batch * seq / (
                time.perf_counter() - t0)
            print(f"  step {step + 1:4d} loss={loss:.4f} ({rate:.0f} tok/s)")
        if (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, params, opt,
                            {"data": corpus.state(), "arch": cfg.name})
    print("[train] done")
    return logged


def main(argv=None) -> list:
    """Run the launcher; returns the (step, loss) pairs it printed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (unreduced) arch config")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 accum=args.accum, lr=args.lr, device=args.device,
                 ckpt_dir=args.ckpt_dir or os.path.join(
                     tempfile.gettempdir(), f"repro_torch_train_{args.arch}"),
                 ckpt_every=args.ckpt_every)


if __name__ == "__main__":
    main()
