"""Multi-round streaming exchange over the blocked-transpose contract.

The same contract as the JAX package's ``runtime/streaming.py``: round r
ships request ranks [r*C_r, (r+1)*C_r) of every (sender, receiver) pair,

  window    w_r(c) = clip(c - r*C_r, 0, C_r)     items a pair ships in round r
  residual  s_r(c) = max(c - (r+1)*C_r, 0)       items still owed after round r

and the rounds repeat while the all-reduced residual is positive, bounded
by a static ``max_rounds``. The JAX package runs them in a
``lax.while_loop``; here the loop is Python and the trip-count rule is
the same, so both run the same rounds on the same values. The residual
is summed over every device of the topology before the loop tests it, so
every rank of a process group runs the same rounds and issues the same
collectives in the same order.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

from repro_torch.runtime import blocking
from repro_torch.runtime.topology import Topology


def round_capacity(total_capacity: int, num_rounds: int) -> int:
    """Per-round pair capacity C_r = ceil(C_total / R), at least 1."""
    if total_capacity < 1:
        raise ValueError(f"total_capacity must be >= 1, got {total_capacity}")
    if num_rounds < 1:
        raise ValueError(f"num_rounds must be >= 1, got {num_rounds}")
    return -(-total_capacity // num_rounds)


def rounds_needed(max_pair_count: int, round_cap: int) -> int:
    """Static round bound: ceil(max possible per-pair count / C_r)."""
    if round_cap < 1:
        raise ValueError(f"round_cap must be >= 1, got {round_cap}")
    return max(-(-max_pair_count // round_cap), 1)


def round_window(counts: torch.Tensor, r: int,
                 round_cap: int) -> torch.Tensor:
    """w_r: how many items each pair ships in round ``r`` (elementwise)."""
    return (counts - r * round_cap).clamp(0, round_cap)


def residual_counts(counts: torch.Tensor, r: int,
                    round_cap: int) -> torch.Tensor:
    """s_r: how many items each pair still owes *after* round ``r``."""
    return (counts - (r + 1) * round_cap).clamp(min=0)


def drive_rounds(indices: Iterable[int],
                 dispatch: Callable[[int], object],
                 writeback: Callable[[int, object], None],
                 overlap: bool = True) -> int:
    """Host-side round driver with double-buffered compute/write overlap.

    ``dispatch(r)`` enqueues round ``r``'s device work and returns at once
    with a handle to its not-yet-finished output; ``writeback(r, handle)``
    waits for that round alone and lands it in the sink. With
    ``overlap=True`` round ``r+1`` is dispatched *before* round ``r`` is
    written back, so the device computes the next round while the host
    writes the previous block; ``overlap=False`` serializes the two.
    Returns the number of rounds driven. ``indices`` may be any subset in
    any order: a resume drives exactly the manifest's missing blocks.
    """
    if not overlap:
        n = 0
        for i in indices:
            writeback(i, dispatch(i))
            n += 1
        return n
    pending = None
    n = 0
    for i in indices:
        handle = dispatch(i)          # the device starts round i now
        if pending is not None:
            writeback(*pending)       # waits on i-1 while i computes
        pending = (i, handle)
        n += 1
    if pending is not None:
        writeback(*pending)
    return n


def run_exchange(counts: torch.Tensor, round_cap: int, max_rounds: int,
                 emit: Callable[[int], torch.Tensor],
                 consume: Callable[[int, torch.Tensor, object], object],
                 init_carry, topo: Topology):
    """Run the multi-round streamed exchange; returns (carry, rounds_run).

    counts: (lp, P) items per pair that will actually ship; only its
      all-reduced sum drives termination.
    emit(r) -> (lp, P, C_r): the provider-side payload of round r.
    consume(r, recv, carry) -> carry: fold round r's received block in.
    """
    owed = int(blocking.all_reduce_sum(counts.sum(), topo))
    rounds = 0
    carry = init_carry
    while rounds < max_rounds and owed > 0:
        recv = blocking.transpose_payload(emit(rounds), topo)
        carry = consume(rounds, recv, carry)
        owed = int(blocking.all_reduce_sum(
            residual_counts(counts, rounds, round_cap).sum(), topo))
        rounds += 1
    return carry, rounds
