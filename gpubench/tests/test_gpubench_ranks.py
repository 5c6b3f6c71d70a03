"""A cell of more than one chip: ``run.launch`` starts one process a
rank (here two, gloo on the CPU), rank 0 prints the result, and a graph
too large to make again whole is compared row by row."""
import argparse
import json

import pytest

from conftest import tiny_pba_graph

from gpubench import check, run
from gpubench.reference import pba


def test_two_ranks_give_one_correct_result(tiny_bench, capfd):
    args = argparse.Namespace(workload="pba_t2", seed=2**31 + 19,
                              seconds=0.5, trace=0)
    code = run.launch(args, 2, backend="gloo", device_type="cpu",
                      **{k: tiny_bench[k] for k in ("bench_path", "dirs")})
    out, err = capfd.readouterr()
    assert code == 0, err[-3000:]
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1                    # rank 0 alone prints
    result = json.loads(lines[0])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["count"] == 2
    assert result["checks"]["digest_mismatch"]["value"] == 0
    assert set(result["metrics"]) == {"edges_per_s.four_chips", "setup_s"}
    assert err.strip().splitlines()[-1].startswith("check ")


def test_a_rank_that_fails_fails_the_run(tiny_bench, capfd):
    args = argparse.Namespace(workload="no_such_cell", seed=1, seconds=0.1,
                              trace=0)
    code = run.launch(args, 2, backend="gloo", device_type="cpu",
                      **{k: tiny_bench[k] for k in ("bench_path", "dirs")})
    capfd.readouterr()
    assert code != 0


def test_jax_loaded_on_another_rank_gives_no_result(tiny_bench, tmp_path,
                                                   capfd):
    # a metric reader that, on rank 1 alone, leaves a module named jax
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics/setup_s.py").write_text(
        "import sys, types\n"
        "import torch.distributed as dist\n"
        "if dist.is_initialized() and dist.get_rank() == 1:\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n"
        "def read(run):\n"
        "    return run.setup_s\n")
    args = argparse.Namespace(workload="pba_t2", seed=2**31 + 29,
                              seconds=0.3, trace=0)
    code = run.launch(args, 2, backend="gloo", device_type="cpu",
                      bench_path=tiny_bench["bench_path"],
                      dirs=(tmp_path,) + tuple(tiny_bench["dirs"]))
    out, err = capfd.readouterr()
    assert code == 3, err[-3000:]
    assert not [ln for ln in out.splitlines() if ln.startswith("{")]
    assert "jax (1 of 2 ranks)" in err


@pytest.mark.parametrize("rows", [[0], [3, 6], [7, 2, 5]])
def test_rows_are_the_whole_graphs_rows(rows):
    graph = {**tiny_pba_graph(), "seed": 23}
    blocks = list(pba.edge_blocks(graph, "cpu"))
    assert check.blocks_digest(pba.row_blocks(graph, rows, "cpu")) == \
        check.blocks_digest(blocks[r] for r in sorted(rows))
    assert check.blocks_digest(pba.row_blocks(graph, rows, "cpu",
                                              control=True)) != \
        check.blocks_digest(blocks[r] for r in sorted(rows))
