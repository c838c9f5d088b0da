"""Device meshes and the process group under them.

The port of :mod:`repro.launch.mesh`.  JAX has one controller for every
device; PyTorch has one process per device, joined by a process group
(NCCL on the card, one rank per card; ``gloo`` on the CPU).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names, over every rank of the group.

    # torchrun --nproc-per-node 4 -m repro_torch.launch.train --model-parallel 2
    init_process_group()            # from torchrun's environment
    mesh = make_mesh_for(4, 2)      # (data 2, model 2)

Without torchrun, :func:`spawn` starts one process per device itself
(``file://`` rendezvous in a temporary directory, a join timeout).

:func:`make_production_mesh` is the reference's 16 x 16 and 2 x 16 x 16
production meshes for the multi-pod dry-run (``launch/dryrun.py``): where
the reference puts 512 placeholder CPU devices under one controller, this
process becomes rank 0 of a ``fake`` process group of 256 or 512 ranks,
whose collectives move nothing.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

AXES = ("data", "model")


def init_process_group(device_type: str = "cuda", *, init_method: str | None = None,
                       rank: int | None = None, world_size: int | None = None,
                       timeout_s: float = 60.0) -> tuple[int, int]:
    """Join (or find) the default process group; returns ``(rank, world)``.

    With no ``init_method`` the group comes from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``); with none of that either,
    a group of one.  On ``"cuda"`` each rank takes the card of its local
    rank and the backend is NCCL; on ``"cpu"`` it is ``gloo``."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device_type='cpu' to run on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0))
                              % torch.cuda.device_count())
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = "nccl" if device_type == "cuda" else "gloo"
    kw = {"timeout": timedelta(seconds=timeout_s)}
    if device_type == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    if init_method is None and "RANK" not in os.environ:
        # a group of one: an in-memory store, no file and no port
        kw.update(store=dist.HashStore(), rank=0, world_size=1)
    else:  # torchrun's environment gives the rank and the world size
        kw["init_method"] = init_method or "env://"
        kw.update({k: v for k, v in (("rank", rank), ("world_size", world_size))
                   if v is not None})
    dist.init_process_group(backend, **kw)
    return dist.get_rank(), dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False):
    """The ``("data", "model")`` 16 x 16 mesh, or the ``("pod", "data",
    "model")`` 2 x 16 x 16 mesh with ``multi_pod``, on a ``fake`` default
    process group of 256 or 512 ranks in which this process is rank 0
    (made here when there is none).  The mesh's device type is ``"cuda"``,
    so DTensor picks the collectives it would pick under NCCL (on a
    ``"cpu"`` mesh an all-to-all becomes an all-gather and a chunk); no
    card is needed, since a dry-run's tensors are on the ``meta`` device.

    Raises when another default group exists: a real group (this process
    holding the card's NCCL group, say) or a fake one of another size.  A
    fake group cannot share a process with a real one, so the caller that
    also runs on the card runs the dry-run in a process of its own."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes)


def make_fake_mesh(shape: tuple, axes: tuple = AXES, device_type: str = "cuda"):
    """A mesh of ``shape`` (dims named ``axes``) on a ``fake`` default
    process group of as many ranks, this process rank 0, made here when
    there is none; raises when another default group exists (see
    :func:`make_production_mesh`).  The dry-run's production meshes, and
    the small meshes that hold a dry-run against a real run of the same
    size (``chip_smoke.py``, the CPU tests)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        backend, size = dist.get_backend(), dist.get_world_size()
        if backend != "fake" or size != world:
            raise RuntimeError(
                f"a default process group already exists ({backend}, {size} "
                f"ranks); a fake mesh of {world} ranks needs a process of its own")
    else:
        # internal API of PyTorch's own tests, imported in this one place
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_mesh_for(devices: int, model_parallel: int = 1, device_type: str = "cuda"):
    """Elastic helper: a ``(data, model)`` mesh over ``devices`` ranks
    (used by the trainer and the elastic-restore tests).  The process group
    must hold exactly ``devices`` ranks."""
    assert devices % model_parallel == 0, (devices, model_parallel)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (devices // model_parallel, model_parallel),
                            mesh_dim_names=AXES)


# ---------------------------------------------------------------------------
# One process per device, started here
# ---------------------------------------------------------------------------


def _child(fn, args, rank, world, root, device_type, timeout_s):
    out = Path(root) / f"rank{rank}.pkl"
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)
        init_process_group(device_type, init_method=f"file://{root}/rdv", rank=rank,
                           world_size=world, timeout_s=timeout_s)
        result = (True, fn(*args))
    except BaseException:  # reported to the parent, which raises
        result = (False, traceback.format_exc())
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    finally:
        with open(out, "wb") as f:
            pickle.dump(result, f)


def spawn(fn, world: int, *args, device_type: str = "cuda", join_timeout_s: float = 120.0,
          pg_timeout_s: float = 60.0) -> list:
    """Run ``fn(*args)`` in ``world`` new processes joined by a process
    group (rank ``r`` on ``cuda:r``; ``device_type="cpu"`` for ``gloo``
    processes with one thread each); returns each rank's result in rank
    order.  ``fn`` must be importable by name.  Raises when a rank
    raises, exits without a result, or is still running ``join_timeout_s``
    after the start (every rank is then killed)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as root:
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(fn, args, r, world, root, device_type, pg_timeout_s))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_timeout_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        if alive:
            raise TimeoutError(f"ranks {alive} of {world} still ran after "
                               f"{join_timeout_s} s")
        results = []
        for r in range(world):
            path = Path(root) / f"rank{r}.pkl"
            if not path.exists():
                raise RuntimeError(f"rank {r} exited with code {procs[r].exitcode} "
                                   "and no result")
            with open(path, "rb") as f:
                ok, value = pickle.load(f)
            if not ok:
                raise RuntimeError(f"rank {r} of {world} failed:\n{value}")
            results.append(value)
        return results
