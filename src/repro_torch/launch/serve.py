"""Serving launcher: --arch <id>, batched requests through the Engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --full-config               # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

The port of the JAX package's ``launch/serve.py``, with its flags, its
float32 model and its workload (random prompts from
``np.random.default_rng(0)``), plus ``--device``. The weights are drawn by
``convert.numpy_params(model, seed=0)``, the tree the CPU tests feed both
packages. :func:`serve` runs that workload for any config
(``examples/torch_serve_decode.py`` calls it). Runs on the card unless
``--device cpu``. The Engine passes tokens only, as the JAX package's
does, so whisper-medium (which needs ``frames``) fails here in both
packages; serve it through ``Model.prefill`` and ``Model.decode_step``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.serve.engine import Engine, Request


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, *, requests: int, batch: int, prompt_len: int,
          new_tokens: int, device=None) -> list:
    """Serve ``requests`` random prompts of ``prompt_len`` tokens through
    the Engine on ``batch`` slots, ``new_tokens`` new tokens each; returns
    the completions."""
    model = build_model(cfg, tp=1, compute_dtype=torch.float32,
                        device=device)
    convert.params_from_numpy(model, convert.numpy_params(model, seed=0))
    print(f"[serve] {cfg.name}: {model.count_params():,} params, "
          f"slots={batch}, device={model.device}")

    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    prompt_len).astype(np.int32),
                    max_new_tokens=new_tokens)
            for i in range(requests)]
    engine = Engine(model, batch_size=batch,
                    max_len=prompt_len + new_tokens, device=model.device)
    _sync(model.device)
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(c.tokens) for c in outs)
    print(f"[serve] {len(outs)} completions, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s)")
    for c in outs[:3]:
        print(f"  req {c.rid}: {c.tokens[:12]}")
    return outs


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default, raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    return serve(cfg, requests=args.requests, batch=args.batch,
                 prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                 device=args.device)


if __name__ == "__main__":
    main()
