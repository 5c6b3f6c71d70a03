"""The port's graph-generation launcher (``repro_torch.launch.generate``)
against the JAX package's ``examples/generate_massive.py``, loaded by
path (nothing in it changes):

  * ``build_specs`` of both give the same spec digests over the flags;
  * the --dry-run plan text is the example's, apart from the device;
  * the checkpoint file is byte-equal, a restart from the example's
    checkpoint makes the same graph, and the refusal of a checkpoint whose
    procs do not divide the devices reads the same (gloo, 3 ranks);
  * on gloo groups of 2 and 4 ranks (``file://`` rendezvous; one group
    initialised by the launcher from torchrun's environment), every
    rank's PBA and PK edges equal the JAX package's host path and
    ``generate_pk`` body bit for bit: flat, --pods 2x2, --exchange-rounds
    4, the paper's 1000 ranks (lp = 250) and --out-dir, whose shard set
    equals the JAX package's;
  * a shard directory the example started resumes under the launcher;
  * without CUDA and without --device cpu it raises before any work.
"""
import argparse
import contextlib
import datetime
import importlib.util
import io
import json
import os
import socket
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from helpers import run_with_devices
from repro_torch.launch import generate as tgen

REPO = Path(__file__).resolve().parents[1]
EXAMPLE = REPO / "examples" / "generate_massive.py"
SPAWN_TIMEOUT_S = 150
SMALL = ["--procs", "8", "--vertices-per-proc", "100",
         "--edges-per-vertex", "3", "--pk-levels", "2"]
ROUNDS = ["--exchange-rounds", "4", "--pair-capacity", "16"]
# the paper's 1000 ranks at a few vertices each: lp = 250 on four ranks,
# a 1000 x 1000 pair matrix in phase 1 and exchange 1
P1000 = ["--procs", "1000", "--vertices-per-proc", "8",
         "--edges-per-vertex", "5", "--pk-levels", "2",
         "--exchange-rounds", "8", "--pair-capacity", "4"]
CASES = {
    2: {"flat": SMALL, "rounds": SMALL + ROUNDS,
        "out_dir": SMALL + ROUNDS + ["--out-dir", "{dir}"]},
    4: {"flat": SMALL, "pods": SMALL + ["--pods", "2x2"],
        "pods_rounds": SMALL + ROUNDS + ["--pods", "2x2"],
        "procs_1000": P1000,
        "out_dir": SMALL + ROUNDS + ["--pods", "2x2", "--out-dir", "{dir}"]},
}


def _example():
    spec = importlib.util.spec_from_file_location("generate_massive",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def example():
    return _example()


def _run_example(example, argv) -> str:
    """The JAX example's main() on this process's one device; stdout."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["generate_massive.py"] + list(argv)
    try:
        with contextlib.redirect_stdout(out):
            example.main()
    finally:
        sys.argv = old
    return out.getvalue()


def _run_port(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tgen.main(list(argv) + ["--device", "cpu"]) == 0
    return out.getvalue()


def _jax_args(argv) -> argparse.Namespace:
    """A namespace with the example's flags (the launcher's parser: the
    same flags and defaults)."""
    return tgen.parser(1).parse_args(argv)


# --- specs, plans, checkpoints ---------------------------------------------------

@pytest.mark.parametrize("argv,n_dev", [
    ([], 1), (["--pair-capacity", "64"], 1), (ROUNDS, 1),
    (["--pods", "2x2"], 4), (["--pods", "2x4", "--no-overlap"], 8),
    (["--out-dir", "/x"], 1), (["--out-dir", "/x", "--pods", "1x2"], 2),
    (["--pk-levels", "7", "--pk-slab-edges", "4096"], 1),
])
def test_build_specs_digests_match(example, argv, n_dev):
    args = _jax_args(argv)
    state = {"seed": 7, "procs": 16, "vpp": 300, "k": 4}
    jpba, jpk = example.build_specs(args, state, n_dev)
    tpba, tpk = tgen.build_specs(args, state, n_dev)
    assert tpba.digest() == jpba.digest()
    assert tpk.digest() == jpk.digest()


def test_build_specs_refuse_a_pod_shape_like_the_example(example):
    args = _jax_args(["--pods", "2x2"])
    state = {"seed": 7, "procs": 8, "vpp": 10, "k": 2}
    with pytest.raises(SystemExit) as want:
        example.build_specs(args, state, 2)
    with pytest.raises(SystemExit) as got:
        tgen.build_specs(args, state, 2)
    assert str(got.value) == str(want.value)


def _no_device(text: str) -> str:
    return text.replace(", device=cpu", "")


@pytest.mark.parametrize("argv", [
    ["--preset", "paper_1b_5b", "--dry-run"],
    ["--preset", "pk_3b", "--dry-run"],
    ["--preset", "hub_stress", "--dry-run", "--out-dir", "{dir}"],
    ["--dry-run", "--procs", "4", "--vertices-per-proc", "500"] + ROUNDS,
])
def test_dry_run_plan_text_matches(example, tmp_path, argv):
    argv = [a.replace("{dir}", str(tmp_path / "ooc")) for a in argv]
    ckpt = ["--ckpt", str(tmp_path / "ckpt.json")]
    want = _run_example(example, argv + ckpt)
    got = _run_port(argv + ckpt)
    assert "device=cpu" in got
    assert _no_device(got) == want
    assert not (tmp_path / "ckpt.json").exists()   # a dry run writes none


def test_checkpoint_bytes_and_restart_match(example, tmp_path, monkeypatch):
    argv = ["--procs", "2", "--vertices-per-proc", "60",
            "--edges-per-vertex", "2", "--pk-levels", "2"]
    _run_example(example, argv + ["--ckpt", str(tmp_path / "jax.json")])
    _run_port(argv + ["--ckpt", str(tmp_path / "port.json")])
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()

    # restart from the example's checkpoint: other scale flags are ignored
    got = []
    real = tgen.run_spec
    monkeypatch.setattr(tgen, "run_spec", lambda *a, **k: got.append(
        real(*a, **k)) or got[-1])
    out = _run_port(["--procs", "4", "--vertices-per-proc", "999",
                     "--pk-levels", "2", "--ckpt", str(tmp_path / "jax.json")])
    assert "restarted from" in out
    from repro import api as japi
    state = json.loads((tmp_path / "jax.json").read_text())
    jspec = _example().build_specs(_jax_args(argv), state, 1)[0]
    want = japi.generate(jspec).edges
    res, _ = got[0]
    np.testing.assert_array_equal(res.edges.src.numpy(), np.asarray(want.src))
    np.testing.assert_array_equal(res.edges.dst.numpy(), np.asarray(want.dst))


def test_no_cuda_raises_before_any_work(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ckpt = tmp_path / "ckpt.json"
    for argv in (["--preset", "paper_smoke"], ["--procs", "2"],
                 ["--preset", "paper_1b_5b", "--dry-run"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgen.main(argv + ["--ckpt", str(ckpt)])
    assert not ckpt.exists()


# --- gloo groups -----------------------------------------------------------------

def _record_runs(out: list):
    """Wrap the launcher's run_spec so each run's share is kept."""
    real = tgen.run_spec

    def run(spec_or_plan, device=None):
        res, wall = real(spec_or_plan, device=device)
        out.append(res)
        return res, wall
    return run


def _case_results(runs: list, prefix: str) -> dict:
    res = {}
    for tag, r in zip(("pba", "pk"), runs):
        res[f"{prefix}_{tag}_stats"] = np.array(json.dumps(
            r.stats.__dict__))
        res[f"{prefix}_{tag}_plan"] = np.array(json.dumps(
            [r.plan.executor, r.plan.topology.label, r.plan.lp]))
        if r.edges is not None:
            res[f"{prefix}_{tag}_src"] = r.edges.src.numpy()
            res[f"{prefix}_{tag}_dst"] = r.edges.dst.numpy()
    return res


def _launch_cases(rank: int, world: int, out: str) -> dict:
    res = {}
    for name, argv in CASES[world].items():
        argv = [a.replace("{dir}", os.path.join(out, name)) for a in argv]
        argv += ["--ckpt", os.path.join(out, f"{name}.ckpt.json"),
                 "--device", "cpu"]
        runs = []
        tgen.run_spec = _record_runs(runs)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            assert tgen.main(argv) == 0
        res.update(_case_results(runs, name))
        res[f"{name}_stdout"] = np.array(text.getvalue())
    return res


def _rank_main(rank, world, init_file, job, out, env_port):
    torch.set_num_threads(1)
    if env_port:
        # the launcher starts (and ends) the group from torchrun's env
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(env_port),
                          LOCAL_RANK=str(rank))
        results = JOBS[job](rank, world, out)
        assert not dist.is_initialized()
    else:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=90))
        try:
            results = JOBS[job](rank, world, out)
        finally:
            dist.destroy_process_group()
    np.savez(os.path.join(out, f"{job}_rank{rank}.npz"), **results)


def _refusal(rank: int, world: int, out: str) -> dict:
    ckpt = os.path.join(out, "ckpt8.json")
    if rank == 0:
        with open(ckpt, "w") as f:
            json.dump({"seed": 7, "procs": 8, "vpp": 10, "k": 2}, f)
    dist.barrier()
    try:
        tgen.main(["--ckpt", ckpt, "--device", "cpu"])
    except SystemExit as e:
        return {"message": np.array(str(e))}
    return {"message": np.array("")}


def _env_group(rank: int, world: int, out: str) -> dict:
    runs = []
    tgen.run_spec = _record_runs(runs)
    with contextlib.redirect_stdout(io.StringIO()):
        tgen.main(SMALL + ["--ckpt", os.path.join(out, "env.ckpt.json"),
                           "--device", "cpu"])
    return _case_results(runs, "env")


JOBS = {"cases": _launch_cases, "refusal": _refusal, "env": _env_group}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(tmp_path, job: str, world: int, env: bool = False) -> list:
    out = tmp_path / f"{job}{world}"
    out.mkdir()
    ctx = mp.spawn(_rank_main,
                   args=(world, str(tmp_path / f"{job}{world}.rdzv"), job,
                         str(out), _free_port() if env else 0),
                   nprocs=world, join=False)
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=SPAWN_TIMEOUT_S)
    while not ctx.join(timeout=5):
        if datetime.datetime.now() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{job}: {world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    return [dict(np.load(out / f"{job}_rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launcher")
    return {w: (spawn(tmp, "cases", w), tmp / f"cases{w}") for w in CASES}


def _jax_state(argv) -> dict:
    args = _jax_args(argv)
    return {"seed": 7, "procs": args.procs,
            "vpp": args.vertices_per_proc, "k": args.edges_per_vertex}


def _jax_pba_rows(argv, world: int):
    """The JAX package's host path for the case's PBA spec: (P, E) arrays."""
    from repro import api as japi
    args = _jax_args(argv)
    spec = _example().build_specs(args, _jax_state(argv), world)[0]
    edges = japi.generate(spec.replace(topology=None)).edges
    return np.asarray(edges.src), np.asarray(edges.dst)


def _jax_pk_chunk(argv, rank: int, world: int):
    """The JAX package's generate_pk body for device ``rank`` of
    ``world`` (-1 past the end)."""
    import jax.numpy as jnp
    from repro.core import pk as jpk
    from repro.runtime import blocking as jblocking
    args = _jax_args(argv)
    seed = jpk.star_clique_seed(5)
    cfg = jpk.PKConfig(levels=args.pk_levels, noise=0.05, seed=3)
    _, e = jpk.pk_sizes(seed, cfg)
    chunk = -(-e // world)
    base = jnp.asarray(jpk.decompose_base(min(rank * chunk, e),
                                          seed.num_edges, cfg.levels))
    u, v = jpk.expand_chunk(jnp.arange(chunk, dtype=jnp.int32), base,
                            jnp.asarray(seed.u), jnp.asarray(seed.v),
                            seed.num_vertices, seed.num_edges, cfg.levels,
                            cfg, rank)
    u, v = jblocking.mask_tail((u, v), rank, chunk, e)
    return np.asarray(u), np.asarray(v)


IN_MEMORY = [(w, name) for w in CASES for name in CASES[w]
             if name != "out_dir"]


@pytest.mark.parametrize("world,name", IN_MEMORY)
def test_every_rank_equals_the_jax_host_path(groups, world, name):
    ranks, _ = groups[world]
    argv = CASES[world][name]
    src, dst = _jax_pba_rows(argv, world)
    p = src.shape[0]
    lp = p // world
    emitted = int((src >= 0).sum())
    for d, r in enumerate(ranks):
        executor, label, r_lp = json.loads(str(r[f"{name}_pba_plan"]))
        assert (executor, r_lp) == ("generate_pba_sharded" if lp > 1
                                    else "generate_pba", lp)
        assert label == ("pods_2x2" if "--pods" in argv
                         else f"flat_1x{world}")
        np.testing.assert_array_equal(r[f"{name}_pba_src"],
                                      src[d * lp:(d + 1) * lp])
        np.testing.assert_array_equal(r[f"{name}_pba_dst"],
                                      dst[d * lp:(d + 1) * lp])
        st = json.loads(str(r[f"{name}_pba_stats"]))
        assert st["emitted_edges"] == emitted
        assert st["dropped_edges"] == src.size - emitted
        u, v = _jax_pk_chunk(argv, d, world)
        np.testing.assert_array_equal(r[f"{name}_pk_src"], u)
        np.testing.assert_array_equal(r[f"{name}_pk_dst"], v)


@pytest.mark.parametrize("world,name", IN_MEMORY)
def test_rank0_prints_the_example_summary(groups, world, name):
    """Rank 0 prints the example's lines, the degree summary from the
    sharded count equal to the JAX package's on its host edges; the other
    ranks print nothing."""
    from repro.core import degree_counts, fit_power_law
    from repro.core.graph import EdgeList
    ranks, _ = groups[world]
    argv = CASES[world][name]
    src, dst = _jax_pba_rows(argv, world)
    st = json.loads(str(ranks[0][f"{name}_pba_stats"]))
    deg = np.asarray(degree_counts(EdgeList(src, dst, st["num_vertices"])))
    fit = fit_power_law(deg, kmin=5)
    lines = str(ranks[0][f"{name}_stdout"]).splitlines()
    args = _jax_args(argv)
    assert lines[0] == (f"devices: {world}, logical processors: "
                        f"{args.procs}")
    assert lines[1].startswith(f"PBA: {st['emitted_edges']:,} edges, "
                               f"{args.procs} logical procs on {world} "
                               "devices in ")
    assert lines[1].endswith(f"drops={st['dropped_edges']}" + (
        f" rounds={st['exchange_rounds']}" if args.exchange_rounds else ""))
    assert lines[2] == (f"     gamma_mle={fit.gamma_mle:.2f}, "
                        f"max_degree={deg.max()}")
    assert lines[3].startswith("PK:  ")
    assert all(str(r[f"{name}_stdout"]) == "" for r in ranks[1:])


@pytest.mark.parametrize("world", sorted(CASES))
def test_out_dir_shards_equal_the_jax_package(groups, tmp_path, world):
    from repro import api as japi
    from repro.core.storage import read_shards as jread
    from repro_torch.core.storage import read_shards
    ranks, out = groups[world]
    argv = CASES[world]["out_dir"]
    args = _jax_args([a.replace("{dir}", str(tmp_path / "jax"))
                      for a in argv])
    jpba, jpk = _example().build_specs(args, _jax_state(argv), world)
    japi.generate(jpba.replace(topology=None))
    japi.generate(jpk)
    for model in ("pba", "pk"):
        src, dst, man = read_shards(str(out / "out_dir" / model))
        wsrc, wdst, wman = jread(str(tmp_path / "jax" / model))
        np.testing.assert_array_equal(src, wsrc)
        np.testing.assert_array_equal(dst, wdst)
        assert man["meta"] == wman["meta"]
    for r in ranks:
        st = json.loads(str(r["out_dir_pba_stats"]))
        assert st["dropped_edges"] == 0
        assert "out_dir_pba_src" not in r      # shards: no edges returned


def test_refusal_matches_the_example(tmp_path):
    """Procs that do not divide the devices: 3 gloo ranks against the
    example on 3 forced host devices, the same message."""
    ranks = spawn(tmp_path, "refusal", 3)
    ckpt = str(tmp_path / "refusal3" / "ckpt8.json")
    want = run_with_devices(f"""
        import importlib.util, sys
        spec = importlib.util.spec_from_file_location("g", {str(EXAMPLE)!r})
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.argv = ["g", "--ckpt", {ckpt!r}]
        try:
            mod.main()
        except SystemExit as e:
            print(e)
    """, 3).strip().splitlines()[-1]
    assert "does not divide over the 3 devices" in want
    assert [str(r["message"]) for r in ranks] == [want] * 3


def test_launcher_starts_and_ends_the_group_from_the_environment(tmp_path):
    """With torchrun's variables and no group, the launcher initialises
    gloo itself (env://), runs and destroys it: both ranks' rows equal
    the JAX host path's."""
    ranks = spawn(tmp_path, "env", 2, env=True)
    src, dst = _jax_pba_rows(SMALL, 2)
    lp = src.shape[0] // 2
    for d, r in enumerate(ranks):
        np.testing.assert_array_equal(r["env_pba_src"],
                                      src[d * lp:(d + 1) * lp])
        np.testing.assert_array_equal(r["env_pba_dst"],
                                      dst[d * lp:(d + 1) * lp])


def test_example_shards_resume_under_the_launcher(example, tmp_path):
    """A shard directory the JAX example wrote, two shards then lost (one
    dropped from the manifest, one file deleted), is finished by the
    launcher: only those two rewritten, the set equal to the example's."""
    from repro_torch.core.storage import read_shards
    argv = ["--procs", "4", "--vertices-per-proc", "300", "--pk-levels",
            "2", "--out-dir", str(tmp_path / "ooc"),
            "--ckpt", str(tmp_path / "ckpt.json")] + ROUNDS
    _run_example(example, argv)
    d = tmp_path / "ooc" / "pba"
    want_src, want_dst, man = read_shards(str(d))
    n = man["num_shards"]
    assert n >= 3
    man["complete"].remove(0)
    del man["counts"]["0"]
    (d / "manifest.json").write_text(json.dumps(man))
    (d / f"shard_{n - 1:05d}.npz").unlink()
    stamps = {i: os.stat(d / f"shard_{i:05d}.npz").st_mtime_ns
              for i in range(n - 1)}
    for i in range(n - 1):
        os.utime(d / f"shard_{i:05d}.npz", ns=(0, 0))
    _run_port(argv)
    rewritten = [i for i in range(n) if i == n - 1 or
                 os.stat(d / f"shard_{i:05d}.npz").st_mtime_ns != 0]
    assert rewritten == [0, n - 1]
    assert stamps
    src, dst, _ = read_shards(str(d))
    np.testing.assert_array_equal(src, want_src)
    np.testing.assert_array_equal(dst, want_dst)


def test_the_example_wrapper_runs_the_launcher():
    spec = importlib.util.spec_from_file_location(
        "torch_generate_massive", REPO / "examples" /
        "torch_generate_massive.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main is tgen.main
