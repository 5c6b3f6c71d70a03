"""The front-door SPMD programs of a plan, as ``(fn, args)`` pairs.

The port of the JAX package's ``launch/bench.py``, whose
``compile_sharded_pba`` and siblings return a jitted program and example
arguments for the collective gate, the auditor and flowcheck to trace.
Here nothing is compiled: ``fn(*args)`` runs the program on the current
process group (this rank's block of it), and the tools observe the run
(``analysis/audit.py`` records its c10d calls, ``analysis/flowcheck.py``
its draws). The names follow the reference's, minus ``compile_``:

  sharded_pba(pl)            phase 1, exchange 1 and exchange 2 of a
                             sharded PBA plan (``pba_logical_block``;
                             with ``exchange_rounds`` the streamed
                             exchange 2 inside it)
  sharded_stream_setup(pl)   the device stream's setup (phase 1 and
                             exchange 1, ``pba_stream_setup_block``)
  sharded_stream_round(pl)   one round of the device stream's exchange 2
                             (``pba_stream_round_block``) on the state the
                             setup leaves (built here, outside ``fn``)
  sharded_cfree(pl)          the communication-free expansion
                             (``core.cfree.generate_cfree``)

Each builder takes a resolved ``api.GenPlan`` whose topology the process
group can run (``Topology.flat(D)`` or ``pods(r, c)`` over a group of D,
or one device with no group).
"""
from __future__ import annotations

from repro_torch.core import cfree, pba
from repro_torch.core.stream import PBAShardedStream


def sharded_pba(pl):
    """(fn, args) of a sharded PBA plan's exchange program:
    ``fn(ranks, procs, s)`` returns ``pba_logical_block``'s (u, v,
    dropped, granted, rounds) for this rank's lp logical processors."""
    cfg, topo = pl.config, pl.topology

    def fn(ranks, procs_blk, s_blk):
        return pba.pba_logical_block(ranks, procs_blk, s_blk, cfg,
                                     pl.num_procs, pl.pair_capacity, topo)
    return fn, pba._block_inputs(pl.table, pl.lp, topo, pl.device)


def sharded_stream_setup(pl):
    """(fn, args) of a streamed plan's setup program: ``fn(ranks, procs,
    s)`` returns (a, occ, recv_counts) of this rank's block. The args
    carry the plan's real faction rows: the one program whose draws and
    runtime inputs meet, which flowcheck's FC001 wants to see."""
    cfg, topo = pl.config, pl.topology

    def fn(ranks, procs_blk, s_blk):
        return pba.pba_stream_setup_block(ranks, procs_blk, s_blk, cfg,
                                          pl.num_procs, topo)
    return fn, pba._block_inputs(pl.table, pl.lp, topo, pl.device)


def sharded_stream_round(pl, r: int = 0):
    """(fn, args) of one round of a streamed plan's exchange 2: ``fn(r)``
    returns the round's (u, v, counts). The resident state (tags, request
    ranks, demand, pools) comes from a ``PBAShardedStream`` of the plan,
    whose setup runs here, before ``fn``."""
    st = PBAShardedStream(pl.config, pl.table, pl.topology,
                          pl.spec.auto_capacity, device=pl.device)

    def fn(round_index):
        return pba.pba_stream_round_block(
            round_index, st._a, st._occ, st._recv, st._pool, st._ranks,
            st.cfg, st.num_procs, st.round_cap, st.urn_budget, st.block_cap,
            st.topology)
    fn.stream = st
    return fn, (r,)


def sharded_cfree(pl):
    """(fn, args) of a communication-free plan's sharded expansion:
    ``fn()`` returns this rank's (EdgeList, GenStats). No collective of
    any kind: the auditor pins it to zero."""
    def fn():
        return cfree.generate_cfree(pl.config, pl.topology, pl.num_procs,
                                    device=pl.device)
    return fn, ()
