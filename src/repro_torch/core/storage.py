"""Sharded edge-list storage: per-shard ``.npz`` pairs and a JSON manifest.

The JAX package's ``core/storage.py`` with the same file names, manifest
keys and ``np.savez_compressed`` format, so a directory written by either
package resumes under the other. Two writers share the format:

  * :func:`write_shards` slices an in-memory EdgeList into shards;
  * :class:`ShardWriter` takes generator blocks one at a time (the
    streams of ``core/stream.py``), so the edge list never has to exist in
    memory at once.

Both resume: each shard and the manifest are written atomically (tmp +
``os.replace``), and the manifest records which shards are complete and
their edge counts. On resume the manifest's ``num_vertices`` /
``num_shards`` and, when both sides carry one, the generator ``meta``
must match the caller's; a mismatch means the directory holds a
different graph and raises instead of interleaving shards of two graphs.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.graph import EdgeList


@dataclasses.dataclass
class ShardManifest:
    num_vertices: int
    num_shards: int
    complete: list
    meta: dict

    def path(self, d: str) -> str:
        return os.path.join(d, "manifest.json")


def _load_manifest(d: str) -> Optional[dict]:
    p = os.path.join(d, "manifest.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _dump_manifest(d: str, man: dict) -> None:
    """Atomic manifest replace: a crash mid-dump must not corrupt resume
    state, so write to a tmp file and os.replace into place."""
    final = os.path.join(d, "manifest.json")
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f)
    os.replace(tmp, final)


def _check_resume(man: dict, num_vertices: int, num_shards: int,
                  meta: Optional[dict] = None) -> None:
    if man["num_shards"] != num_shards:
        raise ValueError(
            f"shard count mismatch with existing manifest: have "
            f"{man['num_shards']}, asked for {num_shards}")
    if man["num_vertices"] != num_vertices:
        raise ValueError(
            f"num_vertices mismatch with existing manifest: have "
            f"{man['num_vertices']}, asked for {num_vertices} — this "
            "directory holds a different graph")
    if meta and man.get("meta") and man["meta"] != meta:
        raise ValueError(
            f"generator meta mismatch with existing manifest: have "
            f"{man['meta']}, asked for {meta} — this directory holds a "
            "different graph")


def _write_shard_file(out_dir: str, i: int, src: np.ndarray,
                      dst: np.ndarray) -> int:
    """Atomically write shard i (invalid -1 slots removed); returns #edges."""
    keep = (src >= 0) & (dst >= 0)
    src, dst = src[keep], dst[keep]
    # np.savez appends ".npz" unless the name already ends with it
    tmp = os.path.join(out_dir, f".shard_{i:05d}.tmp.npz")
    final = os.path.join(out_dir, f"shard_{i:05d}.npz")
    np.savez_compressed(tmp, src=src.astype(np.int32),
                        dst=dst.astype(np.int32))
    os.replace(tmp, final)
    return int(len(src))


def _host(a) -> np.ndarray:
    """A 1-D numpy view of a tensor (copied off the card) or array."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a).reshape(-1)


def write_shards(edges: EdgeList, out_dir: str, num_shards: int = 8,
                 meta: Optional[dict] = None) -> dict:
    """Write (resume) an edge list as num_shards .npz shards + manifest."""
    os.makedirs(out_dir, exist_ok=True)
    man = _load_manifest(out_dir)
    if man is None:
        man = {
            "num_vertices": edges.num_vertices,
            "num_shards": num_shards,
            "complete": [],
            "counts": {},
            "meta": meta or {},
        }
    else:
        _check_resume(man, edges.num_vertices, num_shards, meta)
        man.setdefault("counts", {})
    src = _host(edges.src)
    dst = _host(edges.dst)
    bounds = np.linspace(0, len(src), num_shards + 1).astype(np.int64)
    for i in range(num_shards):
        if i in man["complete"]:
            continue
        n = _write_shard_file(out_dir, i, src[bounds[i]: bounds[i + 1]],
                              dst[bounds[i]: bounds[i + 1]])
        man["complete"].append(i)
        man["counts"][str(i)] = n
        _dump_manifest(out_dir, man)
    return man


class ShardWriter:
    """Resumable block-stream writer: one generator block per shard.

    A stream (``core/stream.py``) produces deterministic block ``i`` on
    demand, so the writer only needs to say which blocks are still
    missing: a restart regenerates exactly those. Shard files and the
    manifest are both written atomically.
    """

    def __init__(self, out_dir: str, num_vertices: int, num_shards: int,
                 meta: Optional[dict] = None):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        man = _load_manifest(out_dir)
        if man is None:
            man = {
                "num_vertices": num_vertices,
                "num_shards": num_shards,
                "complete": [],
                "counts": {},
                "meta": meta or {},
            }
            _dump_manifest(out_dir, man)
        else:
            _check_resume(man, num_vertices, num_shards, meta)
            man.setdefault("counts", {})
        self.manifest = man
        # O(1) membership for is_complete; the manifest list stays the
        # on-disk source of truth.
        self._done = set(man["complete"])

    def is_complete(self, i: int) -> bool:
        return i in self._done

    def missing(self) -> list:
        return [i for i in range(self.manifest["num_shards"])
                if i not in self._done]

    def write_block(self, i: int, src: np.ndarray, dst: np.ndarray) -> None:
        if not 0 <= i < self.manifest["num_shards"]:
            raise ValueError(
                f"block {i} out of range for {self.manifest['num_shards']} "
                "shards")
        src, dst = np.asarray(src), np.asarray(dst)
        if src.shape != dst.shape:
            raise ValueError(
                f"block {i}: src/dst length mismatch "
                f"({src.shape} vs {dst.shape})")
        if self.is_complete(i):
            return
        n = _write_shard_file(self.out_dir, i, src, dst)
        self.manifest["complete"].append(i)
        self._done.add(i)
        self.manifest["counts"][str(i)] = n
        _dump_manifest(self.out_dir, self.manifest)

    @property
    def edges_written(self) -> int:
        return int(sum(self.manifest["counts"].values()))


def read_shards(out_dir: str) -> tuple[np.ndarray, np.ndarray, dict]:
    """Read all complete shards back as a compacted (src, dst, manifest)."""
    man = _load_manifest(out_dir)
    if man is None:
        raise FileNotFoundError(f"no manifest in {out_dir}")
    srcs, dsts = [], []
    for i in sorted(man["complete"]):
        with np.load(os.path.join(out_dir, f"shard_{i:05d}.npz")) as z:
            srcs.append(z["src"])
            dsts.append(z["dst"])
    return (np.concatenate(srcs) if srcs else np.empty(0, np.int32),
            np.concatenate(dsts) if dsts else np.empty(0, np.int32), man)


def iter_shards(out_dir: str) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Stream shards one at a time (out-of-core consumers)."""
    man = _load_manifest(out_dir)
    if man is None:
        raise FileNotFoundError(f"no manifest in {out_dir}")
    for i in sorted(man["complete"]):
        with np.load(os.path.join(out_dir, f"shard_{i:05d}.npz")) as z:
            yield z["src"], z["dst"]
