#!/usr/bin/env bash
# The PyTorch port's verify, on the CPU: the counterpart of
# scripts/verify.sh. spmdlint over the port (python -m repro_torch.analysis,
# the new examples too), the port's tests, a 4-rank gloo run of
# scripts/torch_distributed_check.py --cpu, the c10d auditor and flowcheck
# on 4 gloo ranks, the kernel checker's registry through the plain
# versions, the collective-bytes gate, and the graph launcher's --dry-run
# and paper_smoke legs (one process, and 2 gloo ranks under torchrun).
# Exits non-zero on the first failure; the distributed check's known
# bf16 MoE routing-flip failures, which it names itself, are printed and
# pass.
#
#     scripts/torch_verify.sh
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS=cpu

echo "== environment probe =="
python - <<'PY'
import numpy, pytest, torch
print("torch", torch.__version__, "| cuda", torch.cuda.is_available(),
      "| numpy", numpy.__version__, "| pytest", pytest.__version__)
PY

echo "== spmdlint =="
python -m repro_torch.analysis
python -m repro_torch.analysis lint examples/torch_quickstart.py \
    examples/torch_serve_decode.py examples/torch_train_graph_lm.py \
    examples/torch_generate_massive.py

echo "== the port's tests =="
if python -c "import xdist" 2>/dev/null; then
    python -m pytest -q -p no:cacheprovider -n 6 --dist loadfile \
        tests/test_torch_*.py
else
    python -m pytest -q -p no:cacheprovider tests/test_torch_*.py
fi

echo "== 4 gloo ranks: torch_distributed_check.py --cpu =="
# Every case must pass, except the bf16 MoE training runs the script
# itself lists as known routing-flip failures (ROADMAP Queue 3, open
# conditions); a new failure, or any other case's, fails the verify.
check_out="$(mktemp)"
python -m torch.distributed.run --standalone --nproc_per_node=4 \
    scripts/torch_distributed_check.py --cpu > "$check_out" || true
python - "$check_out" <<'PY'
import json, sys
rows = []
for line in open(sys.argv[1]):
    try:
        rows.append(json.loads(line))
    except ValueError:
        pass
cases = [r for r in rows if "case" in r]
known = [r for r in cases if r["case"] == "lm_train_tp_failures"]
bad = [r for r in cases if r.get("ok") is False and not (
    r["case"] == "lm_train_tp" and r.get("known_routing_flip_failure"))]
new = known[0]["new_failures"] if known else None
print(f"{len(cases)} case lines, known routing-flip failures: "
      f"{known[0]['known_routing_flip_failures'] if known else None}")
if not cases or bad or new:
    for r in bad:
        print("FAILED:", json.dumps(r)[:400])
    print("new failures:", new)
    sys.exit(1)
PY
rm -f "$check_out"

echo "== c10d auditor, flowcheck (4 gloo ranks) =="
python -m repro_torch.analysis audit --ranks 4
python -m repro_torch.analysis flow --ranks 4

echo "== kernel checker: the registry through the plain versions =="
python -m repro_torch.analysis kernels --device cpu

echo "== collective-bytes gate =="
python scripts/torch_collective_gate.py

echo "== graph launcher =="
python -m repro_torch.launch.generate --device cpu --preset paper_1b_5b \
    --dry-run
python -m repro_torch.launch.generate --device cpu --preset paper_smoke
ckpt="$(mktemp -d)"
trap 'rm -rf "$ckpt"' EXIT
python -m torch.distributed.run --standalone --nproc_per_node=2 \
    -m repro_torch.launch.generate --device cpu --procs 8 \
    --vertices-per-proc 2000 --edges-per-vertex 4 --exchange-rounds 4 \
    --pods 1x2 --ckpt "$ckpt/ckpt.json" --out-dir "$ckpt/ooc"

echo "torch verify OK"
