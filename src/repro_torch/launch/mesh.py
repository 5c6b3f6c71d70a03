"""Production mesh construction.

The port of the JAX package's ``launch/mesh.py``. A function, not a
module constant: importing this module touches no device or process
group. :func:`make_production_mesh` returns a
``runtime.topology.Topology`` with the axes ``("data", "model")`` (or
``("pod", "data", "model")``); ``runtime.mesh.ProcessMesh.build`` lays
the process group over it. When the canonical pod shapes (16 x 16
single-pod, 2 x 16 x 16 multi-pod) fit the devices present they are kept
verbatim; otherwise the shape adapts to the device count and kind (TPUs
prefer wide model axes, GPUs a model axis of 8, 4 or 2 within an NVLink
island, hosts a near-square factorization), failing with a clear message
when the count does not factor into a mesh at all. Four H100s give
(data, model) = (2, 2).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.runtime import spmd
from repro_torch.runtime.topology import Topology

_POD_CHIPS = 256          # canonical pod: 16 x 16
_CANON_SINGLE = (16, 16)
_CANON_MULTI = (2, 16, 16)

# Preferred model-axis widths by device family: TPU ICI rings amortize best
# at 16-wide tensor parallelism; NVLink islands at 8.
_MODEL_WIDTHS = {"tpu": (16, 8, 4, 2), "gpu": (8, 4, 2)}


def _kind_family(kind: str) -> str:
    k = kind.lower()
    if "tpu" in k:
        return "tpu"
    if any(t in k for t in ("gpu", "cuda", "rocm", "nvidia", "amd")):
        return "gpu"
    return "cpu"


def _factor2(n: int, kind: str, what: str) -> tuple[int, int]:
    """(data, model) factorization of ``n`` devices, device-kind-aware."""
    for w in _MODEL_WIDTHS.get(_kind_family(kind), ()):
        if n % w == 0 and n // w >= w:
            return (n // w, w)
    a = math.isqrt(n)
    while a > 1 and n % a:
        a -= 1
    if a <= 1:
        if n > 3:
            raise ValueError(
                f"{what}: device count {n} ({kind}) is prime — it does not "
                "factor into a (data, model) mesh; use a composite device "
                "count or build an explicit Topology")
        return (1, n)
    return (n // a, a)


def probe_device_kind() -> str:
    """The card's name (``torch.cuda.get_device_name()``), or "cpu"."""
    return torch.cuda.get_device_name() if torch.cuda.is_available() \
        else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         num_devices: Optional[int] = None,
                         device_kind: Optional[str] = None) -> Topology:
    """Topology for the production serving meshes.

    num_devices defaults to the process group's world size (1 with no
    group), device_kind to :func:`probe_device_kind`; override them for tests or
    capacity planning.
    """
    n = num_devices if num_devices is not None else spmd.device_count()
    kind = device_kind if device_kind is not None else probe_device_kind()
    if multi_pod:
        if n >= 2 * _POD_CHIPS:
            return Topology(("pod", "data", "model"), _CANON_MULTI)
        if n % 2 or n < 4:
            raise ValueError(
                f"multi-pod mesh needs an even device count >= 4, have "
                f"{n} ({kind}); run single-pod or add devices")
        data, model = _factor2(n // 2, kind, "make_production_mesh")
        return Topology(("pod", "data", "model"), (2, data, model))
    if n >= _POD_CHIPS:
        return Topology(("data", "model"), _CANON_SINGLE)
    data, model = _factor2(n, kind, "make_production_mesh")
    return Topology(("data", "model"), (data, model))



def make_proc_mesh(num_procs: int = 0, axis_name: str = "proc") -> Topology:
    """1-D topology over all (or the first N) devices for the graph
    generators: ``Topology.flat`` of the world size (or N)."""
    have = spmd.device_count()
    if num_procs and have < num_procs:
        raise ValueError(f"need {num_procs} devices, have {have}")
    return Topology.flat(num_procs or have, axis_name)
