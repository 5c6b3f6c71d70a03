"""The host-driven stream (``core/stream.py::PBAStream``) in blocks of
rows, and the shard writer's resume after a shard file is deleted:
what the paper's full 1000-rank graph needs of the one-device
reference, held to the JAX package's ``PBAStream`` bit for bit on the
CPU.

``PBAStream`` runs phase 1 and resolves every edge's endpoint in blocks
of :func:`host_chunk_rows` rows, so neither the card nor the host holds
a (P, E) urn's temporaries at once: the blocks must not change a block
of the stream, however the rows are cut.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import stream as jstream
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import storage as tstorage
from repro_torch.core import stream as tstream

CPU = torch.device("cpu")
CASES = {
    "hub_stress": ("hub_stress", {}),
    "paper_smoke_r4": ("paper_smoke", {"exchange_rounds": 4,
                                       "pair_capacity": 64,
                                       "vertices_per_proc": 300}),
    # the paper's 1000 ranks: (1000, 1000) counts, rows cut mid-faction
    "procs_1000": ("paper_1b_5b", {"vertices_per_proc": 8,
                                   "pair_capacity": 4}),
}


def _inputs(name):
    preset, overrides = CASES[name]
    pl = japi.plan(japi.preset(preset, **overrides))
    cfg = dataclasses.replace(pl.config, pair_capacity=pl.pair_capacity)
    return (cfg, pl.table, convert.pba_config_from_fields(
        dataclasses.asdict(cfg)), convert.faction_table_from_numpy(
            pl.table.procs, pl.table.s, pl.table.factions))


@pytest.mark.parametrize("rows", [1, 3, 7])
@pytest.mark.parametrize("name", sorted(CASES))
def test_rows_in_blocks_give_the_reference_stream(name, rows, monkeypatch):
    cfg, table, tcfg, ttab = _inputs(name)
    want = jstream.PBAStream(cfg, table)
    monkeypatch.setattr(tstream, "host_chunk_rows", lambda e, d: rows)
    got = tstream.PBAStream(tcfg, ttab, device=CPU)
    assert got.num_blocks == want.num_blocks
    assert got.urn_budget == want.urn_budget
    assert got.meta() == want.meta()
    for i in range(want.num_blocks):
        wu, wv = want.block(i)
        gu, gv = got.block(i)
        assert gu.dtype == gv.dtype == np.int32
        np.testing.assert_array_equal(gu, wu)
        np.testing.assert_array_equal(gv, wv)


def test_host_chunk_rows_fit_a_quarter_of_the_budget():
    # the CPU's fixed 8 GiB budget: 2 GiB a block at 48 B a slot
    assert tstream.host_chunk_rows(5_000_000, CPU) == \
        (8 << 30) // 4 // (48 * 5_000_000) == 8
    assert tstream.host_chunk_rows(10, CPU) > 1000
    assert tstream.host_chunk_rows(1 << 40, CPU) == 1


def test_a_deleted_shard_file_is_rewritten(tmp_path):
    """A shard the manifest calls complete whose file is gone is missing
    again: a rerun rewrites it alone, and the set reads back whole."""
    spec = tapi.preset("hub_stress", sink="shards",
                       out_dir=str(tmp_path / "s"))
    tapi.generate(spec, device=CPU)
    src, dst, man = tstorage.read_shards(str(tmp_path / "s"))
    n = man["num_shards"]
    gone = n // 2
    path = tmp_path / "s" / f"shard_{gone:05d}.npz"
    path.unlink()
    for i in range(n):
        if i != gone:
            os.utime(tmp_path / "s" / f"shard_{i:05d}.npz", ns=(0, 0))
    writer = tstorage.ShardWriter(str(tmp_path / "s"), man["num_vertices"],
                                  n, man["meta"])
    assert writer.missing() == [gone]
    tapi.generate(spec, device=CPU)
    assert [i for i in range(n) if os.stat(
        tmp_path / "s" / f"shard_{i:05d}.npz").st_mtime_ns] == [gone]
    again, again_dst, _ = tstorage.read_shards(str(tmp_path / "s"))
    np.testing.assert_array_equal(again, src)
    np.testing.assert_array_equal(again_dst, dst)
