"""Minimal batched serving engine over the prefill/decode steps.

The port of the JAX package's ``serve/engine.py``, with its semantics:
synchronous slot-based batching, a fixed batch of request slots; each wave
of requests is left-padded with token 0 to the workload's longest prompt
(the pad is attended to: the reference applies no padding mask), idle
slots of a partial wave replay slot 0 and their completions are dropped by
``rid``, decoding runs ``min(max_new_tokens of the wave, max_len -
prompt_len)`` steps, a completion is cut after its first ``eos_id``, and
completions come back in finish order.

Each step's tokens stay on the device until the wave ends, so the decode
loop never waits for the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.runtime import spmd
from repro_torch.serve.serve_step import make_serve_fns


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,) int32
    max_new_tokens: int


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray


class Engine:
    """Serves requests with ``model``'s parameters. Runs on the card unless
    ``device="cpu"``; the model must be on the same device."""

    def __init__(self, model: Model, batch_size: int, max_len: int,
                 eos_id: Optional[int] = None, device=None):
        self.device = spmd.resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine "
                             f"on {self.device}")
        self.model = model
        self.batch = batch_size
        self.max_len = max_len
        self.eos_id = eos_id
        self._prefill, self._decode = make_serve_fns(model, max_len=max_len)

    @torch.inference_mode()
    def run(self, requests: list[Request]) -> list[Completion]:
        """Serve a workload; returns completions in finish order."""
        if not requests:
            return []
        plen = max(len(r.prompt) for r in requests)
        done: list[Completion] = []
        queue = list(requests)

        while queue:
            wave = queue[: self.batch]
            queue = queue[self.batch:]
            # pad the wave to the full slot batch (idle slots replay slot 0)
            while len(wave) < self.batch:
                wave.append(wave[0])
            prompts = np.zeros((self.batch, plen), np.int64)
            for i, r in enumerate(wave):
                prompts[i, -len(r.prompt):] = r.prompt  # left-pad
            batch = {"tokens": torch.from_numpy(prompts).to(self.device)}
            logits, caches = self._prefill(batch)
            tok = logits[:, -1:].argmax(dim=-1)
            out = []
            steps = max(r.max_new_tokens for r in wave)
            for t in range(min(steps, self.max_len - plen)):
                out.append(tok)
                logits, caches = self._decode(tok, caches, plen + t)
                tok = logits[:, -1:].argmax(dim=-1)
            toks_all = (torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
                        if out else np.zeros((self.batch, 0), np.int32))
            seen = set()
            for i, r in enumerate(wave):
                if r.rid in seen:
                    continue
                seen.add(r.rid)
                toks = toks_all[i, : r.max_new_tokens]
                if self.eos_id is not None:
                    hits = np.nonzero(toks == self.eos_id)[0]
                    if hits.size:
                        toks = toks[: hits[0] + 1]
                done.append(Completion(r.rid, toks))
        return done
