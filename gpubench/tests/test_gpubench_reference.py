"""The plain reference against the program's plain path on the CPU, at
small sizes: the same graph, edge for edge."""
import pytest
import torch

from conftest import tiny_pba_graph, tiny_rmat_graph

from gpubench import check
from gpubench.reference import pba, rmat


def program_graph(graph: dict, **routing):
    from repro_torch import api
    fields = dict(graph)
    if isinstance(fields.get("factions"), dict):
        fields["factions"] = api.FactionSpec(**fields["factions"])
    return api.generate(api.GraphSpec(**fields, **routing), device="cpu")


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2])
@pytest.mark.parametrize("execution", ["streamed_device", "streamed_host",
                                       "host"])
def test_pba_reference_is_the_programs_graph(seed, execution):
    from repro_torch import api
    graph = {**tiny_pba_graph(), "seed": seed}
    routing = {"streamed_device": dict(execution="streamed",
                                       topology=api.Topology.flat(1)),
               "streamed_host": dict(execution="streamed"),
               "host": dict(execution="host")}[execution]
    if execution == "host":
        # the host path draws its pools at the static budget, and drops
        # what a pool cannot grant
        graph["auto_capacity"] = False
    res = program_graph(graph, **routing)
    src, dst = res.edges.src.reshape(-1), res.edges.dst.reshape(-1)
    keep = (src >= 0) & (dst >= 0)
    want = check.blocks_digest(pba.edge_blocks(graph, "cpu"))
    assert check.digest(src[keep], dst[keep]) == want
    if graph["auto_capacity"]:
        assert want[0] == pba.requested_edges(graph)


def test_pba_reference_rows_hold_their_own_vertices():
    graph = {**tiny_pba_graph(), "seed": 3}
    v, k = graph["vertices_per_proc"], graph["edges_per_vertex"]
    for i, (u, dst) in enumerate(pba.edge_blocks(graph, "cpu")):
        assert u.numel() == v * k
        assert bool(((u // v) == i).all())
        assert int(dst.min()) >= 0
        assert int(dst.max()) < graph["procs"] * v


def test_pba_faction_table_matches_the_programs():
    from repro_torch.core import factions
    for p, spec in ((8, (4, 2, 4, 1)), (64, (32, 2, 32, 1)),
                    (1000, (500, 2, 500, 1))):
        want = factions.make_factions(p, factions.FactionSpec(*spec))
        rows, sizes = pba.make_factions(p, *spec)
        assert (rows == want.procs).all() and (sizes == want.s).all()


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2])
def test_rmat_reference_is_the_programs_graph(seed):
    graph = {**tiny_rmat_graph(), "seed": seed}
    res = program_graph(graph, execution="host")
    t = torch.arange(graph["cfree_edges"], dtype=torch.int64)
    u, v = rmat.endpoints_at([graph], t)
    assert torch.equal(u[0], res.edges.src)
    assert torch.equal(v[0], res.edges.dst)
    assert check.digest(res.edges.src, res.edges.dst) == \
        check.blocks_digest(rmat.edge_blocks(graph, "cpu"))


def test_rmat_reference_batches_graphs_by_seed():
    graphs = [{**tiny_rmat_graph(), "seed": s} for s in (1, 2, 3)]
    t = torch.tensor([0, 5, 1 << 15, (1 << 16) - 1])
    u, v = rmat.endpoints_at(graphs, t)
    for k, g in enumerate(graphs):
        uk, vk = rmat.endpoints_at([g], t)
        assert torch.equal(u[k], uk[0]) and torch.equal(v[k], vk[0])


def test_rmat_thresholds_are_the_specs():
    g = tiny_rmat_graph()
    assert rmat.thresholds(g) == (int(0.57 * 2**32), int(0.76 * 2**32),
                                  int(0.95 * 2**32))


@pytest.mark.parametrize("module", [pba, rmat])
def test_control_changes_the_graph(module):
    graph = {**(tiny_pba_graph() if module is pba else
                {**tiny_rmat_graph(), "cfree_edges": 1 << 18}), "seed": 11}
    want = check.blocks_digest(module.edge_blocks(graph, "cpu"))
    got = check.blocks_digest(module.edge_blocks(graph, "cpu",
                                                 control=True))
    assert got[0] == want[0] and got != want
