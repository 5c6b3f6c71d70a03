"""``scripts/torch_collective_gate.py`` passes on the tree and fails on
seeded regressions, each made in a copy of the script and the port under
the test's tmp dir (nothing in the repository changes):

  * a full-size buffer: the exchange's payload padded to a fixed width
    before its transpose (the same values, bytes no longer scaling with
    the pair capacity or the rounds) trips legs 1 and 1b;
  * a smuggled all_to_all: the communication-free generator transposes
    a dummy counts matrix, so it issues a collective, which trips leg 2b.

The gate runs on 2 gloo ranks here (the pod legs need 4; the committed
baseline holds both counts); each regression runs the legs it must trip.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

MUTATIONS = {
    "tree": None,
    "full_size_buffer": (
        "runtime/blocking.py",
        "    return _transpose_blocked(buf, topo)\n",
        "    width = buf.shape[-1]\n"
        "    pad = torch.full(buf.shape[:-1] + (max(4096 - width, 0),), -1,\n"
        "                     dtype=buf.dtype, device=buf.device)\n"
        "    return _transpose_blocked(torch.cat([buf, pad], -1),\n"
        "                              topo)[..., :width]\n",
        "leg 1: exchange bytes do not scale with pair_capacity", "1"),
    "smuggled_all_to_all": (
        "core/cfree.py",
        "    start = blocking.device_index(topo) * lp * chunk\n",
        "    start = blocking.device_index(topo) * lp * chunk\n"
        "    if blocking.collective(topo):\n"
        "        blocking.transpose_counts(torch.zeros(\n"
        "            (lp, p), dtype=torch.int32, device=device), topo)\n",
        "leg 2b:", "2b"),
}


def _copy(tmp: Path, mutation) -> Path:
    root = tmp / "repo"
    (root / "scripts").mkdir(parents=True)
    shutil.copy(REPO / "scripts" / "torch_collective_gate.py",
                root / "scripts")
    (root / "results").mkdir()
    shutil.copy(REPO / "results" / "torch_collective_bytes_baseline.json",
                root / "results")
    shutil.copytree(REPO / "src" / "repro_torch",
                    root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__",
                                                  "*.json"))
    if mutation is not None:
        rel, old, new, _, _ = mutation
        path = root / "src" / "repro_torch" / rel
        text = path.read_text()
        assert text.count(old) == 1, (rel, old)
        path.write_text(text.replace(old, new))
    return root


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_gate(case, tmp_path):
    root = _copy(tmp_path, MUTATIONS[case])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(root / "src")
    legs = ["--legs", MUTATIONS[case][4]] if MUTATIONS[case] else []
    proc = subprocess.run(
        [sys.executable, str(root / "scripts" / "torch_collective_gate.py"),
         "--ranks", "2", "--timeout", "240"] + legs,
        capture_output=True, text=True, env=env, timeout=300, cwd=root)
    if MUTATIONS[case] is None:
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "torch collective gate OK" in proc.stdout
        assert "no baseline" not in proc.stdout   # the committed one holds
    else:
        assert proc.returncode == 1, (proc.stdout, proc.stderr[-3000:])
        assert MUTATIONS[case][3] in proc.stderr, proc.stderr[-3000:]
