"""Batched serving demo on the PyTorch/CUDA port: prefill a batch of
prompts, decode new tokens (the counterpart of
``examples/serve_decode.py``).

    PYTHONPATH=src python examples/torch_serve_decode.py --arch qwen1.5-0.5b
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu

The JAX example's flags plus ``--device``, over the serving launcher
(``launch/serve.py::serve``): the reduced config in float32, its weights
``convert.numpy_params(model, seed=0)``, ``--batch`` prompts from
``np.random.default_rng(0)`` served at once on as many slots, greedy
decoding through the Engine. The Engine passes tokens only, so
whisper-medium fails here as in the launcher. Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.serve import serve


def main(argv=None) -> list:
    """Run the demo; returns the completions."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default, raises without a card) or cpu")
    args = ap.parse_args(argv)
    return serve(get_config(args.arch).reduced(), requests=args.batch,
                 batch=args.batch, prompt_len=args.prompt_len,
                 new_tokens=args.new_tokens, device=args.device)


if __name__ == "__main__":
    main()
