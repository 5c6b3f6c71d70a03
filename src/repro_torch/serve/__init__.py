"""Serving: prefill / decode steps and the batched request engine (the JAX
package's ``serve/``)."""
from repro_torch.serve.engine import Completion, Engine, Request
from repro_torch.serve.serve_step import make_serve_fns, prefill_input_structs
