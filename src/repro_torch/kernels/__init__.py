"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``ops.py`` holds the entry points the generators call, ``ref.py`` the
plain versions, ``edge_resolve.py``, ``histogram.py``,
``band_compact.py``, ``pk_expand.py`` and ``cfree_expand.py`` the
wrappers of the CUDA sources in ``csrc/``, built on first use by
``_build.py``, and ``geometry.py`` the pure launch geometry every wrapper
launches with.

This package also hosts the **kernel registry** the kernel checker sweeps
(``python -m repro_torch.analysis kernels``), the port of the JAX
package's ``repro.kernels.registry``: the same five entries, the same
sizes and the same numpy seeds, so a case's inputs are the reference's
own. A case's ``fn`` is the port's wrapper, ``ref`` its plain version in
``ref.py``, ``geometry`` the launches it makes on a card of given limits
(``geometry.py``), and ``oracle`` the same function written with the JAX
package's ``ref`` module, which a caller passes in (this package never
imports it). The port's path kernels are further cases of the same
entries: ``resolve_roots``, ``gather`` and ``gather_chunked`` beside the
one-pass ``resolve_step``, the masked ``histogram`` and one case per
histogram regime at an H100's boundaries, and ``ops.pk_expand``'s noise
form with its own draws. Builders import their modules on first use.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One (kernel entry point, example inputs, plain version) triple.

    ``args`` holds numpy arrays (made on the host from the reference's
    seeds) and plain values; :meth:`tensors` moves the arrays to a device.
    ``fn`` and ``ref`` take the tensors (static parameters are closed
    over). ``execute`` marks the sizes the reference runs in interpret
    mode (the CPU differential takes them; on the card every case runs).
    ``launches``: the key of ``ops.launch_counts()`` one call of ``fn``
    adds one to. ``inplace``: ``fn`` writes its first argument.
    ``geometry(limits)``: the launches one call makes on a card of
    ``limits`` (``geometry.Limits``). ``oracle(ref, asarray, *args)``:
    the JAX package's ``ref`` oracle of the same function, ``asarray``
    turning a numpy array into that package's array.
    """

    fn: Callable
    args: tuple
    ref: Callable
    label: str
    execute: bool = True
    launches: str = ""
    inplace: bool = False
    geometry: Optional[Callable] = None
    oracle: Optional[Callable] = None

    def tensors(self, device) -> tuple:
        """``args`` with every numpy array a tensor on ``device``."""
        import numpy as np
        import torch
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     if isinstance(a, np.ndarray) else a for a in self.args)


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One registered kernel: ``build(**size)`` -> KernelCase per size.

    ``sizes`` is a zero-arg callable (sizes may depend on derived bounds,
    like edge_resolve's ``CHUNKED_MIN_ENTRIES``); ``meta`` gives the
    static facts the checker's inventory records."""

    name: str
    build: Callable
    sizes: Callable
    meta: Optional[Callable] = None


# --- edge_resolve ------------------------------------------------------------

def _urn(rng, rows: int, m: int):
    """PBA-like urn pointers (rows, m): slot j points at or below j, the
    first slots are roots."""
    import numpy as np
    j = np.arange(m)
    ptr = np.floor(rng.random((rows, m)) * j).astype(np.int32)
    ptr[:, :min(m, 7)] = j[:min(m, 7)]
    return ptr


def _edge_resolve_case(m: int, chunked: bool = False,
                       slab: int | None = None,
                       dst_block: int | None = None, op: str = "",
                       rows: int = 0, n: int = 0) -> KernelCase:
    import numpy as np

    from repro_torch.kernels import edge_resolve, geometry, ops, ref

    if op == "resolve_roots":
        rng = np.random.default_rng(2000 + m + rows)
        ptr = _urn(rng, max(rows, 1), m)
        ptr = ptr if rows else ptr[0]

        def oracle(jref, asarray, p):
            cur = asarray(p)
            while True:
                nxt = jref.resolve_step_ref(cur) if cur.ndim == 1 else \
                    asarray(np.stack([np.asarray(jref.resolve_step_ref(c))
                                      for c in cur]))
                if bool((nxt == cur).all()):
                    return cur
                cur = nxt
        return KernelCase(
            fn=ops.resolve_roots, args=(ptr,), ref=ref.resolve_roots_ref,
            label=f"resolve_roots_r{rows}_m{m}" if rows
            else f"resolve_roots_m{m}", launches="resolve_roots",
            inplace=True,
            geometry=lambda lim: (geometry.resolve_roots(max(rows, 1), m),),
            oracle=oracle)
    if op == "gather":
        rng = np.random.default_rng(3000 + m + n + rows)
        shape = (rows, m) if rows else (m,)
        src = rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int64) \
            .astype(np.int32)
        # a few indices past either end: the contract clips them
        idx = rng.integers(-3, m + 3, (rows, n) if rows else (n,)) \
            .astype(np.int32)
        chunked_path = m >= edge_resolve.CHUNKED_MIN_ENTRIES
        return KernelCase(
            fn=ops.gather, args=(src, idx), ref=ref.gather_ref,
            label=(f"gather_r{rows}_m{m}_n{n}" if rows
                   else f"gather{'_chunked' if chunked_path else ''}"
                        f"_m{m}_n{n}"),
            execute=m * max(rows, 1) <= 1 << 20,
            launches="gather_chunked" if chunked_path else "gather",
            geometry=lambda lim: (geometry.gather(
                max(rows, 1), n, lim.sms * lim.gather_blocks_per_sm),),
            oracle=lambda jref, asarray, s, i: jref.gather_ref(asarray(s),
                                                               asarray(i)))
    rng = np.random.default_rng(1000 + m)
    ptr = rng.integers(0, m, m).astype(np.int32)
    one_pass = lambda lim: (geometry.gather(  # noqa: E731
        1, m, lim.sms * lim.gather_blocks_per_sm),)
    oracle = lambda jref, asarray, p: jref.resolve_step_ref(  # noqa: E731
        asarray(p))
    if chunked:
        # The chunked regime: one doubling pass as the src == idx gather
        # through the chunked entry point (on the card the same kernel as
        # the resident one, with its own launch count: the source has no
        # slabs, so ``slab`` only names the reference's case).
        return KernelCase(
            fn=lambda p: edge_resolve.gather_chunked(p, p), args=(ptr,),
            ref=ref.resolve_step_ref,
            label=f"m{m}_chunked" + (f"_s{slab}" if slab else ""),
            execute=m <= 8192, launches="gather_chunked", geometry=one_pass,
            oracle=oracle)
    return KernelCase(fn=ops.resolve_step, args=(ptr,),
                      ref=ref.resolve_step_ref, label=f"m{m}",
                      execute=m <= 8192, launches="resolve_step",
                      geometry=one_pass, oracle=oracle)


def _edge_resolve_sizes() -> tuple:
    from repro_torch.kernels.edge_resolve import CHUNKED_MIN_ENTRIES
    # The reference's MAX_VMEM_ENTRIES (the largest source its TPU VMEM
    # holds whole) has no counterpart on the card, which serves any source
    # from L2 and device memory; its place is taken by the port's own
    # bound, the largest source ops.gather sends to the resident entry
    # point rather than gather_chunked.
    bound = CHUNKED_MIN_ENTRIES - 1
    return ({"m": 1}, {"m": 127}, {"m": 4097}, {"m": bound},
            {"m": bound + 1, "chunked": True},
            {"m": 4097, "chunked": True, "slab": 1024, "dst_block": 1024},
            # the port's path kernels
            {"m": 4097, "op": "resolve_roots"},
            {"m": 5000, "rows": 4, "op": "resolve_roots"},
            {"m": 70001, "n": 4099, "op": "gather"},
            {"m": 5003, "n": 2049, "rows": 3, "op": "gather"},
            {"m": CHUNKED_MIN_ENTRIES, "n": 4096, "op": "gather"})


def _edge_resolve_meta() -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.edge_resolve import CHUNKED_MIN_ENTRIES
    return {
        "chunked_min_entries": CHUNKED_MIN_ENTRIES,
        "fallback_events": dict(ops.FALLBACK_EVENTS),
        "oversize_fallback": (
            "none: the card's gather serves any source from L2 and device "
            "memory, so ops.FALLBACK_EVENTS stays empty by design; "
            "ops.gather sends sources of chunked_min_entries or more to "
            "gather_chunked, the same kernel under its own launch count"),
    }


# --- band_compact ------------------------------------------------------------

def _band_compact_case(rows: int, e: int, cap: int) -> KernelCase:
    import numpy as np

    from repro_torch.kernels import geometry, ops, ref

    rng = np.random.default_rng(rows * 131 + e * 17 + cap)
    u = rng.integers(0, 2**30, (rows, e)).astype(np.int32)
    v = rng.integers(0, 2**30, (rows, e)).astype(np.int32)
    band = rng.random((rows, e)) < 0.35
    return KernelCase(
        fn=lambda u_, v_, b_: ops.band_compact(u_, v_, b_, cap),
        args=(u, v, band),
        ref=lambda u_, v_, b_: ref.band_compact_ref(u_, v_, b_, cap),
        label=f"r{rows}_e{e}_c{cap}", execute=rows * e <= 65536,
        launches="band_compact",
        geometry=lambda lim: geometry.band_compact(rows, e),
        oracle=lambda jref, asarray, u_, v_, b_: jref.band_compact_ref(
            asarray(u_), asarray(v_), asarray(b_), cap))


def _band_compact_sizes() -> tuple:
    return ({"rows": 1, "e": 1, "cap": 1},
            {"rows": 2, "e": 1500, "cap": 600},
            {"rows": 4, "e": 8192, "cap": 2048},
            {"rows": 1, "e": 262144, "cap": 65536})


def _band_compact_meta() -> dict:
    from repro_torch.kernels.geometry import THREADS
    return {
        "threads": THREADS["band_compact"],
        "tile_entries": 16 * 1024,
        "note": ("prefix-sum compaction in two launches behind one entry "
                 "(a count pass and a scatter pass, one block per tile of "
                 "16384 entries), replacing the reference's one-hot "
                 "accumulation with an SMEM cursor"),
    }


# --- histogram ---------------------------------------------------------------

def _histogram_case(m: int, nbins: int, masked: bool = False,
                    regime: str = "") -> KernelCase:
    import numpy as np

    from repro_torch.kernels import geometry, ops, ref

    rng = np.random.default_rng(m * 31 + nbins)
    v = rng.integers(0, nbins, m).astype(np.int32)
    geo = lambda lim: (geometry.histogram(  # noqa: E731
        1, nbins, masked, lim.sms, lim.smem_optin),)
    label = f"m{m}_b{nbins}" + (f"_{regime}" if regime else "")
    if masked:
        mask = rng.random(m) < 0.35
        return KernelCase(
            fn=lambda v_, k_: ops.histogram(v_, nbins, k_), args=(v, mask),
            ref=lambda v_, k_: ref.histogram_ref(v_, nbins, k_),
            label=label + "_masked", launches="histogram", geometry=geo,
            oracle=lambda jref, asarray, v_, k_: jref.histogram_ref(
                asarray(np.where(k_, v_, -1).astype(np.int32)), nbins))
    return KernelCase(
        fn=lambda v_: ops.histogram(v_, nbins), args=(v,),
        ref=lambda v_: ref.histogram_ref(v_, nbins), label=label,
        execute=m <= 8192 or bool(regime), launches="histogram",
        geometry=geo,
        oracle=lambda jref, asarray, v_: jref.histogram_ref(asarray(v_),
                                                            nbins))


def regime_boundaries() -> dict:
    """The bin counts at which ``histogram.regime`` changes regime on an
    H100: the last of the block regime, the first and last of the
    cluster regime, the first of the global."""
    from repro_torch.kernels.geometry import H100 as lim
    from repro_torch.kernels.geometry import THREADS
    from repro_torch.kernels.histogram import (CLUSTER_MAX, STAGE_BYTES,
                                               regime)
    per_block = (lim.smem_optin - STAGE_BYTES) // 4
    out = {"block_last": per_block, "cluster_first": per_block + 1,
           "cluster_last": CLUSTER_MAX * per_block,
           "global_first": CLUSTER_MAX * per_block + 1}
    want = ("block", "cluster", "cluster", "global")
    got = tuple(regime(b, lim.smem_optin, THREADS["histogram"],
                       STAGE_BYTES).kind for b in out.values())
    if got != want:
        raise AssertionError(f"histogram regimes at {out}: {got}")
    return out


def _histogram_sizes() -> tuple:
    edges = regime_boundaries()
    return ({"m": 1, "nbins": 1}, {"m": 2048, "nbins": 512},
            {"m": 5003, "nbins": 700}, {"m": 65536, "nbins": 1537},
            # the port's path kernels: the masked count, and each regime
            # at its boundaries on an H100
            {"m": 65536, "nbins": 1537, "masked": True},
            {"m": 70001, "nbins": edges["block_last"], "regime": "block"},
            {"m": 70001, "nbins": edges["cluster_first"],
             "regime": "cluster"},
            {"m": 70001, "nbins": edges["cluster_last"],
             "regime": "cluster"},
            {"m": 70001, "nbins": edges["global_first"],
             "regime": "global"})


def _histogram_meta() -> dict:
    from repro_torch.kernels.histogram import (CLUSTER_MAX, COPIES_BYTES,
                                               STAGE_BYTES)
    return {"regime_boundaries_h100": regime_boundaries(),
            "cluster_max": CLUSTER_MAX, "copies_bytes": COPIES_BYTES,
            "stage_bytes": STAGE_BYTES}


# --- pk_expand ---------------------------------------------------------------

def _pk_expand_case(m: int, n0: int, levels: int, noise: bool,
                    ops_noise: float = 0.0) -> KernelCase:
    import numpy as np

    from repro_torch.core.pk import decompose_base, star_clique_seed
    from repro_torch.kernels import dispatch, geometry, ops, ref
    from repro_torch.kernels import pk_expand as pk

    seed = star_clique_seed(n0)
    e0 = seed.num_edges
    rng = np.random.default_rng(m * 13 + n0 * 7 + levels)
    hi = min(e0 ** levels, 2**31 - 1)
    t = rng.integers(0, max(hi - m, 1), m).astype(np.int32)
    base = tuple(int(d) for d in decompose_base(
        int(rng.integers(0, max(hi // 2, 1))), e0, levels))
    su, sv = seed.u, seed.v
    label = f"m{m}_n{n0}_L{levels}"
    geo = lambda lim: (geometry.pk_expand(m, e0, lim.sms),)  # noqa: E731
    if ops_noise:
        # ops.pk_expand's noise form: the flips, redraws and deletions
        # drawn from the (seed, stream, rank) keys, then the kernel.
        kw = dict(noise=ops_noise, delete_prob=ops_noise / 2, seed=7,
                  rank=3)

        def plain(t_, b_, u_, v_):
            with dispatch.forced_mode("ref"):
                return ops.pk_expand(t_, b_, u_, v_, n0, e0, levels, **kw)

        def oracle(jref, asarray, t_, b_, u_, v_):
            import torch

            from repro_torch.core import rng as rng_lib
            ck = rng_lib.device_key(7, rng_lib.STREAM_PK_NOISE_COIN, 3)
            dk = rng_lib.device_key(7, rng_lib.STREAM_PK_NOISE_DIGIT, 3)
            xk = rng_lib.device_key(7, rng_lib.STREAM_PK_XOR, 3)
            flip = rng_lib.coin(ck, levels * m, ops_noise).reshape(levels, m)
            redraw = (rng_lib.bits(dk, levels * m) % e0).to(torch.int32) \
                .reshape(levels, m)
            gone = rng_lib.coin(xk, m, ops_noise / 2).numpy()
            uu, vv = jref.pk_expand_ref(
                asarray(t_), asarray(np.asarray(b_, np.int32)), asarray(u_),
                asarray(v_), n0, e0, levels, asarray(flip.numpy()),
                asarray(redraw.numpy()))
            return (np.where(gone, -1, np.asarray(uu)),
                    np.where(gone, -1, np.asarray(vv)))
        return KernelCase(
            fn=lambda t_, b_, u_, v_: ops.pk_expand(t_, b_, u_, v_, n0, e0,
                                                    levels, **kw),
            args=(t, base, su, sv), ref=plain, label=label + "_ops_noise",
            execute=m <= 8192, launches="pk_expand", geometry=geo,
            oracle=oracle)
    if noise:
        flip = rng.random((levels, m)) < 0.3
        redraw = rng.integers(0, e0, (levels, m)).astype(np.int32)
        return KernelCase(
            fn=lambda t_, b_, u_, v_, f_, r_: pk.pk_expand(
                t_, b_, u_, v_, n0, e0, levels, f_, r_),
            args=(t, base, su, sv, flip, redraw),
            ref=lambda t_, b_, u_, v_, f_, r_: ref.pk_expand_ref(
                t_, b_, u_, v_, n0, e0, levels, f_, r_),
            label=label + "_noise", launches="pk_expand", geometry=geo,
            oracle=lambda jref, asarray, t_, b_, u_, v_, f_, r_:
                jref.pk_expand_ref(asarray(t_), asarray(np.asarray(
                    b_, np.int32)), asarray(u_), asarray(v_), n0, e0,
                    levels, asarray(f_), asarray(r_)))
    return KernelCase(
        fn=lambda t_, b_, u_, v_: pk.pk_expand(t_, b_, u_, v_, n0, e0,
                                               levels),
        args=(t, base, su, sv),
        ref=lambda t_, b_, u_, v_: ref.pk_expand_ref(t_, b_, u_, v_, n0, e0,
                                                     levels),
        label=label, launches="pk_expand", geometry=geo,
        oracle=lambda jref, asarray, t_, b_, u_, v_: jref.pk_expand_ref(
            asarray(t_), asarray(np.asarray(b_, np.int32)), asarray(u_),
            asarray(v_), n0, e0, levels))


def _pk_expand_sizes() -> tuple:
    return ({"m": 100, "n0": 3, "levels": 2, "noise": False},
            {"m": 3000, "n0": 5, "levels": 4, "noise": False},
            {"m": 2048, "n0": 6, "levels": 3, "noise": True},
            # the port's path: ops.pk_expand's noise form
            {"m": 3001, "n0": 5, "levels": 4, "noise": False,
             "ops_noise": 0.1})


def _pk_expand_meta() -> dict:
    from repro_torch.kernels.geometry import PK_SHARED_TAB
    return {"shared_table_entries": PK_SHARED_TAB,
            "note": ("4 edges a thread; e0 divided by a multiply-high "
                     "(pk_expand.division_magic); the seed tables in "
                     "shared memory up to shared_table_entries each")}


# --- cfree_expand ------------------------------------------------------------

def _cfree_expand_case(m: int, model: str, n: int,
                       degree: int = 2) -> KernelCase:
    import numpy as np

    from repro_torch.core.cfree import (CFreeConfig, cfree_words,
                                        rmat_thresholds)
    from repro_torch.kernels import geometry, ops, ref

    e = n * degree if model == "ba_cfree" else max(m, 1)
    cfg = CFreeConfig(model=model, vertices=n, edges=e, ba_degree=degree,
                      seed=m * 7 + n)
    words = tuple(int(w) for w in cfree_words(cfg))
    th = rmat_thresholds(cfg)
    rng = np.random.default_rng(m * 29 + n)
    t = rng.integers(0, e, m).astype(np.int32)
    kw = dict(model=model, n=n, ba_degree=degree, thresholds=th)
    return KernelCase(
        fn=lambda t_, w_: ops.cfree_expand(t_, w_, **kw), args=(t, words),
        ref=lambda t_, w_: ref.cfree_expand_ref(t_, w_, **kw),
        label=f"{model}_m{m}_n{n}", execute=m <= 8192,
        launches="cfree_expand",
        # the wrapper allocates u, v at t's phase; a fresh tensor has 0
        geometry=lambda lim: (geometry.cfree_expand(m, 0, model, lim.sms),),
        oracle=lambda jref, asarray, t_, w_: jref.cfree_expand_ref(
            asarray(t_), asarray(np.asarray(w_, np.uint32)), **kw))


def _cfree_expand_sizes() -> tuple:
    return ({"m": 100, "model": "ba_cfree", "n": 64, "degree": 3},
            {"m": 3000, "model": "ba_cfree", "n": 4096},
            {"m": 2048, "model": "rmat", "n": 1024},
            {"m": 1500, "model": "er", "n": 777})


def _cfree_expand_meta() -> dict:
    from repro_torch.core.cfree import CHAIN_BOUND
    return {
        "chain_bound": CHAIN_BOUND,
        "note": ("elementwise uint32 mixing, no exchange; a ba_cfree chain "
                 "ends at its first even draw (the same values as the "
                 "reference's chain_bound masked hops), a queue per warp "
                 "over a tile of consecutive edges"),
    }


def registry() -> tuple[KernelEntry, ...]:
    """Every kernel entry point the port can launch, with the sizes the
    kernel checker sweeps it over."""
    return (
        KernelEntry("edge_resolve", _edge_resolve_case, _edge_resolve_sizes,
                    _edge_resolve_meta),
        KernelEntry("band_compact", _band_compact_case, _band_compact_sizes,
                    _band_compact_meta),
        KernelEntry("histogram", _histogram_case, _histogram_sizes,
                    _histogram_meta),
        KernelEntry("pk_expand", _pk_expand_case, _pk_expand_sizes,
                    _pk_expand_meta),
        KernelEntry("cfree_expand", _cfree_expand_case, _cfree_expand_sizes,
                    _cfree_expand_meta),
    )
