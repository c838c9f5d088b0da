"""Atomic, async checkpointing of trees of tensors.

The port of :mod:`repro.checkpoint.checkpointer`, with the same on-disk
layout, so a checkpoint written by either package restores in the other:

    <dir>/step_<n>/{manifest.json, arrays/<leaf-id>.npy}

Leaf keys are the dict keys, list indices and NamedTuple field names from
the root joined by ``/`` (``params/embeddings/embed``, ``opt/m/...``), in
the reference's leaf order.  Writes go to a temp directory and are
atomically renamed, so a preemption mid-save can never corrupt the latest
checkpoint.  ``keep`` old checkpoints are retained.

bfloat16 leaves are written as the reference writes them: the raw 2-byte
words under the descriptor ``<V2`` with manifest dtype ``"bfloat16"``.
They go through an ``int16`` view both ways, so neither side needs a
bfloat16 numpy type.

On a device mesh the leaves are DTensors.  ``save`` is then called on
every rank: each leaf is gathered whole (``full_tensor``), only rank 0
writes (the same files, byte for byte), and every rank waits at a barrier
until the rename has published the step.  ``restore(like, step,
shardings=)`` puts each whole array onto the mesh and placements it is
given (a tree of :class:`repro_torch.models.sharding.NamedSharding`), or
onto those of ``like``'s DTensor leaves: the elastic path, where a
checkpoint from N ranks restores onto M.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from ..tree import leaf_paths, unflatten

_STEP_RE = re.compile(r"^step_(\d+)$")
BF16 = "bfloat16"


def _leaf_keys(tree) -> list[tuple[str, object]]:
    return [("/".join(str(k) for k in path), leaf) for path, leaf in leaf_paths(tree)]


def _to_host(leaf):
    """A tensor copied to host memory (the step that follows may reuse
    the device buffer), a DTensor gathered whole first; other leaves as
    they are."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if hasattr(leaf, "full_tensor"):
            leaf = leaf.full_tensor()
        return leaf.to("cpu", copy=True)
    return leaf


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def _place(t: torch.Tensor, sharding, like):
    """A restored whole array put where it belongs: onto ``sharding``'s
    mesh and placements, else onto ``like``'s (a DTensor's placements, a
    tensor's dtype and device)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if sharding is not None:
        mesh, placements = sharding.mesh, sharding.placements()
    elif isinstance(like, DTensor):
        mesh, placements = like.device_mesh, like.placements
    else:
        if isinstance(like, torch.Tensor):
            t = t.to(device=like.device, dtype=like.dtype)
        return t
    if isinstance(like, torch.Tensor):
        t = t.to(dtype=like.dtype)
    t = t.to(torch.device(mesh.device_type, torch.cuda.current_device())
             if mesh.device_type == "cuda" else mesh.device_type)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _save_npy(path: Path, leaf) -> tuple[str, list[int]]:
    """Write one leaf as ``.npy``; returns (manifest dtype, shape)."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        words = leaf.contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": "<V2", "fortran_order": False, "shape": words.shape})
            f.write(words.tobytes())
        return BF16, list(words.shape)
    arr = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    np.save(path, arr, allow_pickle=False)
    return str(arr.dtype), list(arr.shape)


def _load_npy(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3, async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._queue: queue.Queue | None = None
        self._worker = None
        self._error: Exception | None = None
        if async_save:
            self._queue = queue.Queue(maxsize=2)
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state: dict) -> None:
        """state: tree dict (params/opt/data/step...).  Async if enabled;
        the tensors are copied to the host before this returns.  Under a
        process group every rank calls it; rank 0 writes and the others wait
        for the step to be published (synchronous then)."""
        host_state = unflatten(state, [_to_host(l) for _, l in _leaf_keys(state)])
        if _distributed():
            if torch.distributed.get_rank() == 0:
                self._write(step, host_state)
            torch.distributed.barrier()
            return
        if self._queue is not None:
            if self._error:
                raise self._error
            self._queue.put((step, host_state))
        else:
            self._write(step, host_state)

    def wait(self) -> None:
        if self._queue is not None:
            self._queue.join()
            if self._error:
                raise self._error

    def _drain(self):
        while True:
            step, state = self._queue.get()
            try:
                self._write(step, state)
            except Exception as e:  # surfaced on next save()/wait()
                self._error = e
            finally:
                self._queue.task_done()

    def _write(self, step: int, state: dict) -> None:
        final = self.dir / f"step_{step}"
        tmp = self.dir / f".tmp_step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        (tmp / "arrays").mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, (key, leaf) in enumerate(_leaf_keys(state)):
            fname = f"{i:05d}.npy"
            dtype, shape = _save_npy(tmp / "arrays" / fname, leaf)
            manifest["leaves"].append(
                {"key": key, "file": fname, "dtype": dtype, "shape": shape}
            )
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            m = _STEP_RE.match(p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: int | None = None, shardings=None):
        """Rebuild the tree ``like`` from disk: a tensor leaf of ``like``
        gives its dtype and device to the restored leaf; any other leaf
        (a number) comes back as a CPU tensor of the stored dtype.
        ``shardings`` (a tree congruent with ``like`` of ``NamedSharding``
        or None) re-shards onto a mesh — the elastic path: a checkpoint
        from N ranks restores onto M.  A DTensor leaf of ``like`` with no
        sharding given keeps its own mesh and placements."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        root = self.dir / f"step_{step}"
        manifest = json.loads((root / "manifest.json").read_text())
        by_key = {l["key"]: l for l in manifest["leaves"]}

        by_path = dict(_leaf_keys(shardings)) if shardings is not None else {}
        leaves = []
        for key, leaf_like in _leaf_keys(like):
            shd = by_path.get(key)
            entry = by_key.get(key)
            if entry is None:
                raise KeyError(f"checkpoint at step {step} missing leaf {key!r}")
            t = _load_npy(root / "arrays" / entry["file"], entry["dtype"])
            leaves.append(_place(t, shd, leaf_like))
        return unflatten(like, leaves)
