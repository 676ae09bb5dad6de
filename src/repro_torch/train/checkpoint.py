"""Fault-tolerant checkpointing — torch port of
``repro.train.checkpoint``, with the same on-disk format, so either
package restores the other's checkpoints.

  * layout: ``<dir>/step_<9 digits>/leaves.npz`` holds the tree's leaves
    as ``leaf_<i>`` in ``jax.tree_util`` order (``repro_torch.tree``),
    bfloat16 stored as its uint16 bit pattern; ``meta.json`` records the
    step, the leaf count, each leaf's dtype name, ``extra`` and the
    sha256 of ``leaves.npz``;
  * device-count independent: leaves are saved as full logical arrays
    and placed on the template's devices on restore, or by
    ``shardings`` as ``DTensor`` shards of another mesh (elastic
    resharding: save on one mesh, restore on another).  A tree of
    ``DTensor`` leaves is saved collectively: every rank calls ``save``
    (the full tensors are gathered), rank 0 writes, and every rank
    returns once the write is done;
  * atomic: write to ``<dir>/tmp.<step>`` then ``os.replace`` — a crash
    mid-write never corrupts the latest checkpoint;
  * validated: ``restore`` verifies the checksum and raises the typed
    ``CheckpointCorrupt`` on any torn or garbled checkpoint instead of
    surfacing a random zipfile/JSON decode error (callers catch ONE
    exception to fall back to the previous step); a checkpoint written
    before the checksum existed still loads;
  * async: ``AsyncCheckpointer.save_async`` copies the tree to host
    memory synchronously and writes it in a daemon thread, overlapping
    the disk with the next steps;
  * emergency: ``install_sigterm_handler`` flushes a final checkpoint on
    preemption (SIGTERM);
  * GC: keep the most recent ``keep`` checkpoints.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed

from .. import tree as tree_util

# numpy's npz format has no bfloat16: it is stored as uint16 + a dtype
# tag (the JAX package writes its ml_dtypes bfloat16 arrays the same way)
_EXT_DTYPES = ("bfloat16",)


class CheckpointCorrupt(RuntimeError):
    """A checkpoint directory exists but fails validation (missing or
    undecodable meta/leaves, checksum mismatch).  The one exception a
    restore caller needs to catch to fall back to an older step."""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _full(x):
    """A leaf as one full tensor: a ``DTensor`` gathered from its shards
    (a collective every rank of its mesh joins), else as it is."""
    return x.full_tensor() if _is_dtensor(x) else x


def _snapshot(x) -> Any:
    """A copy of a leaf on the host: torch tensors (a ``DTensor``
    gathered) copied to the CPU, the rest as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return _full(x.detach()).to("cpu", copy=True)
    return np.asarray(x)


def _writer(leaves) -> bool:
    """Whether this process writes a checkpoint of these leaves: every
    process, unless they hold ``DTensor`` shards; then rank 0."""
    return not (any(_is_dtensor(x) for x in leaves)
                and torch.distributed.get_rank() != 0)


def _encode(x):
    """A leaf -> (numpy array for the npz, dtype name)."""
    if isinstance(x, torch.Tensor):
        x = _full(x.detach()).cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = x.numpy()
        return a, a.dtype.name
    x = np.asarray(x)
    name = x.dtype.name
    if name in _EXT_DTYPES:
        return x.view(np.uint16), name
    return x, name


def _decode(a: np.ndarray, name: Optional[str]) -> torch.Tensor:
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    if name in _EXT_DTYPES:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Synchronous atomic checkpoint write. Returns the final path."""
    leaves = tree_util.leaves(tree)
    encoded = [_encode(x) for x in leaves]      # gathers DTensor leaves
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if _writer(leaves):
        _write(ckpt_dir, step, final, encoded, extra, keep)
    if any(_is_dtensor(x) for x in leaves):
        torch.distributed.barrier()        # every rank sees the write
    return final


def _write(ckpt_dir: str, step: int, final: str, encoded,
           extra: Optional[dict], keep: int):
    os.makedirs(ckpt_dir, exist_ok=True)
    host_leaves = [e[0] for e in encoded]
    dtypes = [e[1] for e in encoded]
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "leaves.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
    meta = {"step": step, "n_leaves": len(host_leaves),
            "dtypes": dtypes, "extra": extra or {},
            "checksum": _sha256(os.path.join(tmp, "leaves.npz"))}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def restore(ckpt_dir: str, step: int, template: Any, *,
            shardings: Any = None):
    """Restore into the structure of ``template``.  Each leaf goes to
    the device of the template's leaf in its place (the CPU where that
    is not a tensor; a ``DTensor`` template leaf gets this rank's shard
    on its mesh); if ``shardings`` is given (a tree of
    ``launch.mesh.Sharding``), each becomes a ``DTensor`` on its mesh
    instead, every rank keeping its own shard — this is where elastic
    resharding happens.

    A *missing* checkpoint raises ``FileNotFoundError`` (absence is
    not corruption); a *present-but-invalid* one — torn meta.json,
    truncated/garbled leaves, checksum mismatch — raises the typed
    ``CheckpointCorrupt``."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    leaves_path = os.path.join(path, "leaves.npz")
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if not isinstance(meta, dict) or "n_leaves" not in meta:
            raise ValueError("meta.json missing n_leaves")
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(f"{path}: bad meta.json: {e}") from e
    want = meta.get("checksum")
    if want is not None:
        try:
            got = _sha256(leaves_path)
        except OSError as e:
            raise CheckpointCorrupt(f"{path}: missing leaves: {e}") from e
        if got != want:
            raise CheckpointCorrupt(
                f"{path}: leaves.npz checksum mismatch "
                f"(want {want[:12]}…, got {got[:12]}…)")
    dtypes = meta.get("dtypes", [None] * meta["n_leaves"])
    try:
        with np.load(leaves_path) as data:
            leaves = [_decode(data[f"leaf_{i}"], dtypes[i])
                      for i in range(meta["n_leaves"])]
    except Exception as e:       # zipfile/KeyError/ValueError zoo
        raise CheckpointCorrupt(f"{path}: bad leaves.npz: {e}") from e
    if shardings is not None:
        def put(a, s):
            dev = torch.device(s.mesh.device_type)
            if dev.type == "cuda":
                dev = torch.device("cuda", torch.cuda.current_device())
            return _shard(a.to(dev), s.mesh, s.placements)
        placed = [put(a, s) for a, s in
                  zip(leaves, tree_util.leaves(shardings))]
    else:
        placed = [_like(a, t) for a, t in
                  zip(leaves, tree_util.leaves(template))]
    return tree_util.unflatten(template, placed), meta


def _like(a: torch.Tensor, t) -> torch.Tensor:
    """A restored leaf placed as the template's leaf ``t``: on its
    device, or, for a ``DTensor``, as this rank's shard of it."""
    if _is_dtensor(t):
        return _shard(a.to(t.device), t.device_mesh, t.placements)
    return a.to(t.device if isinstance(t, torch.Tensor) else "cpu")


def _shard(a: torch.Tensor, mesh, placements):
    """This rank's shard of the full tensor ``a`` (which every rank
    holds) as a ``DTensor``: sliced locally, no collective."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(a, mesh, list(placements), src_data_rank=None)


class AsyncCheckpointer:
    """Snapshot-then-write-in-background checkpointer."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree: Any, *,
                   extra: Optional[dict] = None):
        self.wait()
        # synchronous device->host snapshot (consistent view; a DTensor
        # is gathered, by every rank) …
        host_tree = tree_util.tree_map(_snapshot, tree)
        if not _writer(tree_util.leaves(tree)):
            return
        # … asynchronous disk write.
        self._thread = threading.Thread(
            target=save, args=(self.ckpt_dir, step, host_tree),
            kwargs={"extra": extra, "keep": self.keep}, daemon=True)
        self._thread.start()


def install_sigterm_handler(flush: Callable[[], None]):
    """Emergency-checkpoint on preemption."""
    def handler(signum, frame):
        flush()
        raise SystemExit(143)
    signal.signal(signal.SIGTERM, handler)
