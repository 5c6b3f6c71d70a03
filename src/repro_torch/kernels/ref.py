"""Plain PyTorch versions of every kernel (the correctness contracts).

These are the JAX package's ``repro.kernels.ref`` oracles in torch, over a
single row or a ``(rows, m)`` batch. The CPU path runs them, and the
kernels are held against them on the card.
"""
from __future__ import annotations

import torch

#: Edges per chunk of the elementwise plain versions: each edge is pure in
#: its inputs, so chunking bounds the int64 temporaries without changing
#: a value.
CHUNK = 1 << 24


def resolve_step_ref(ptr: torch.Tensor) -> torch.Tensor:
    """One pointer-doubling pass along the last axis: ptr'[j] = ptr[ptr[j]].

    Returns a new tensor: the pass reads only the old pointers."""
    return torch.gather(ptr, -1, ptr.long())


def resolve_roots_ref(ptr: torch.Tensor) -> torch.Tensor:
    """The fixpoint of the doubling pass along the last axis of (m,) or
    (rows, m): :func:`resolve_step_ref` passes until ``ptr[ptr] == ptr``,
    so every slot holds the root of its chain.

    Written into ``ptr`` in place, as the kernel does, and returned.
    Raises ``ValueError`` on a pointer outside [0, its slot]: the urns
    point downward, which is what makes the chains end.
    """
    j = torch.arange(ptr.shape[-1], dtype=ptr.dtype, device=ptr.device)
    if bool(((ptr < 0) | (ptr > j)).any()):
        raise ValueError("resolve_roots: a pointer lies outside [0, its "
                         "slot]")
    cur = ptr
    while True:
        nxt = resolve_step_ref(cur)
        if torch.equal(nxt, cur):
            break
        cur = nxt
    if cur is not ptr:
        ptr.copy_(cur)
    return ptr


def gather_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[..., k] = src[..., clip(idx[..., k], 0, m-1)] along the last axis.

    ``src`` and ``idx`` have the same rank: (m,) with (n,), or (rows, m)
    with (rows, n).
    """
    m = src.shape[-1]
    return torch.gather(src, -1, idx.clamp(0, m - 1).long())


def histogram_ref(values: torch.Tensor, num_bins: int,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Bincount of int32 values in [0, num_bins), out-of-range ignored.

    ``values`` (n,) gives (num_bins,); (rows, n) gives (rows, num_bins).
    With a bool ``mask`` of the values' shape, only the values where it
    is set are counted: the bincount of ``where(mask, values, -1)``.
    """
    if mask is not None:
        values = torch.where(mask, values, -1)
    rows = values.reshape(1, -1) if values.ndim == 1 else values
    ok = (rows >= 0) & (rows < num_bins)
    v = torch.where(ok, rows, num_bins).long()
    counts = torch.zeros((rows.shape[0], num_bins + 1), dtype=torch.int32,
                         device=values.device)
    counts.scatter_add_(1, v, torch.ones_like(v, dtype=torch.int32))
    return counts[0, :num_bins] if values.ndim == 1 \
        else counts[:, :num_bins]


def band_compact_ref(u: torch.Tensor, v: torch.Tensor, band: torch.Tensor,
                     block_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable band compaction per row of (rows, e) int32 ``u``, ``v`` and
    bool ``band``: band entries move to the front in index order,
    everything else is -1, truncated to ``block_cap`` columns (fewer when
    e < block_cap). The key/argsort/take sequence of the JAX package's
    oracle; keys are unique, so the argsort needs no stability."""
    e = u.shape[-1]
    j = torch.arange(e, dtype=torch.int64, device=u.device)
    order = torch.argsort(torch.where(band, j, e + j), dim=-1)
    order = order[..., :block_cap]
    uu = torch.gather(torch.where(band, u, -1), -1, order)
    vv = torch.gather(torch.where(band, v, -1), -1, order)
    return uu, vv


def pk_expand_ref(t_local: torch.Tensor, base_digits, seed_u: torch.Tensor,
                  seed_v: torch.Tensor, n0: int, e0: int, levels: int,
                  flip: torch.Tensor | None = None,
                  redraw: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mixed-radix Kronecker edge expansion of (m,) int32 local indices.

    Base-e0 digits of ``t_local`` (LSB first), a carry add of the (L,)
    MSB-first ``base_digits`` of the range start, optional noise (where
    the (L, m) bool ``flip`` is set, the digit becomes ``redraw``'s), then
    ``u = sum_i seed_u[d_i] * n0^(L-1-i)`` by Horner in int32 (likewise
    ``v``). The JAX package's ``ref.pk_expand_ref``, in chunks of edges.
    """
    m = t_local.shape[0]
    dev = t_local.device
    base = [int(d) for d in base_digits]
    su, sv = seed_u.to(dev).long(), seed_v.to(dev).long()
    u = torch.empty(m, dtype=torch.int32, device=dev)
    v = torch.empty(m, dtype=torch.int32, device=dev)
    for a in range(0, m, CHUNK):
        rem = t_local[a:a + CHUNK]
        carry = torch.zeros_like(rem)
        digits = [None] * levels                # MSB first
        for i in range(levels):                 # LSB -> MSB
            row = rem % e0 + base[levels - 1 - i] + carry
            rem = rem // e0
            carry = (row >= e0).to(torch.int32)
            digits[levels - 1 - i] = row - carry * e0
        uu = torch.zeros_like(carry)
        vv = torch.zeros_like(carry)
        for i in range(levels):
            d = digits[i]
            if flip is not None:
                d = torch.where(flip[i, a:a + CHUNK], redraw[i, a:a + CHUNK],
                                d)
            d = d.long()
            uu = uu * n0 + su[d].to(torch.int32)
            vv = vv * n0 + sv[d].to(torch.int32)
        u[a:a + CHUNK] = uu
        v[a:a + CHUNK] = vv
    return u, v


def cfree_expand_ref(t: torch.Tensor, words, *, model: str, n: int,
                     ba_degree: int, thresholds: tuple
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Communication-free endpoints of (m,) int32 global edge indices via
    the plain functions of ``core/cfree.py`` (which hold the math), in
    chunks of edges."""
    from repro_torch.core import cfree
    m = t.shape[0]
    u = torch.empty(m, dtype=torch.int32, device=t.device)
    v = torch.empty(m, dtype=torch.int32, device=t.device)
    for a in range(0, m, CHUNK):
        tc = t[a:a + CHUNK]
        if model == "ba_cfree":
            uu = torch.div(tc, ba_degree, rounding_mode="floor")
            vv = cfree.ba_dst(words, tc, ba_degree)
        elif model == "rmat":
            uu, vv = cfree.rmat_endpoints(words, tc, n.bit_length() - 1,
                                          *thresholds)
        else:
            uu, vv = cfree.er_endpoints(words, tc, n)
        u[a:a + CHUNK] = uu
        v[a:a + CHUNK] = vv
    return u, v
