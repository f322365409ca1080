"""Ranks and their mesh: the port's counterpart of JAX's one-axis device mesh.

JAX runs one process and places a ``shard_map`` over a ``Mesh`` of devices.
The port runs one process per rank under ``torch.distributed``: each
sharded function of this package runs inside every rank, takes the rank's
local shard and returns the rank's local shard (the body of JAX's
``shard_map``). Collectives stand where JAX has them: ``all_gather`` for
``lax.all_gather``, a send to rank + 1 for ``lax.ppermute``.

One process per card keeps the launches of each card on their own host
thread: the engines are bound by launches, and one thread driving several
cards would serialise them.

The collectives carry a few KB (4x4 totals, BA window tails, packed window
rows). They run on the device the backend serves: CUDA tensors for NCCL,
host tensors for gloo (gloo takes CUDA tensors only for ``broadcast`` and
``all_reduce``), so ranks that share one card use gloo and stage these bytes
through the host. NCCL refuses two ranks on one card. Compute stays on the
rank's device either way.

``run_ranks`` starts the ranks on one host (``spawn``, a ``file://`` store
in a fresh temporary directory, loopback for gloo) and returns each rank's
result to the caller.
"""

from __future__ import annotations

import contextlib
import os
import queue as queue_mod
import tempfile
import traceback
from pathlib import Path
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """One rank's view of the one-axis mesh over the default (world) process
    group: its rank, size, compute device and the group's backend.
    ``counts`` tallies the collectives this rank issued through the helpers
    below (``all_gather``, ``p2p``)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    counts: dict


def make_mesh(n_devices: int | None = None,
              device: str | torch.device | None = None) -> Mesh:
    """This rank's ``Mesh`` over the initialised default process group.

    The device is the CUDA card unless ``device`` says otherwise: rank r
    takes ``cuda:{r % torch.cuda.device_count()}`` (ranks that share a card
    take the same one). A mesh that cannot have what it was asked for
    raises: ``n_devices`` other than the group's size, no card, or NCCL on
    the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (see run_ranks)")
    rank, size = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"need a mesh of {n_devices} ranks, the group has {size}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card (torch.cuda.is_available() is False); pass "
                               "device='cpu' to run the ranks on the CPU")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    device = torch.device(device)
    backend = str(dist.get_backend())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend serves CUDA devices only")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(rank, size, device, backend, {"all_gather": 0, "p2p": 0})


def _wire(mesh: Mesh) -> torch.device:
    """Device the collectives' tensors live on: the card for NCCL, else the host."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(size, *x.shape) stack of every rank's ``x`` (all the same shape), on
    this rank's device."""
    x = x.contiguous().to(_wire(mesh))
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(out, x)
    mesh.counts["all_gather"] += 1
    return torch.stack(out).to(mesh.device)


def send_to_next(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Send ``x`` to rank + 1 and return what rank - 1 sent (zeros on rank
    0): JAX's ``ppermute`` with ``perm=[(d, d + 1)]``. The last rank sends
    nothing."""
    x = x.contiguous().to(_wire(mesh))
    got = torch.zeros_like(x)
    ops = []
    if mesh.rank + 1 < mesh.size:
        ops.append(dist.P2POp(dist.isend, x, mesh.rank + 1))
    if mesh.rank > 0:
        ops.append(dist.P2POp(dist.irecv, got, mesh.rank - 1))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        mesh.counts["p2p"] += 1
    return got.to(mesh.device)


@contextlib.contextmanager
def process_group(backend: str, world_size: int, rank: int, store: str | Path):
    """Initialise the default process group from the ``file://`` store
    ``store`` (a path no earlier group used) and destroy it on exit."""
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=world_size,
                            rank=rank)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, fn, world_size: int, backend: str, device, store: str, results,
               args) -> None:
    """Body of one spawned rank: join the group, build the mesh, run
    ``fn(mesh, *args)`` and put (rank, ok, result or traceback) on ``results``."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank is on this host
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    try:
        with process_group(backend, world_size, rank, store):
            out = fn(make_mesh(world_size, device=device), *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, backend: str = "gloo",
              device: str | torch.device | None = None, *args, timeout: float = 1800.0
              ) -> list:
    """Run ``fn(mesh, *args)`` in ``world_size`` spawned ranks on this host
    and return their results, by rank.

    ``fn`` must be a module-level function (the ranks import it by name) and
    return something picklable (numpy arrays, not CUDA tensors). ``device``
    is each rank's device as ``make_mesh`` takes it (None: the cards,
    round-robin). Spawn, not fork: the caller may hold a CUDA context. A
    rank that fails, dies or outlasts ``timeout`` seconds ends every rank,
    and the error is raised here with the rank's traceback."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        store = str(Path(tmp) / "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, fn, world_size, backend, device, store, results, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got: dict[int, Any] = {}
        try:
            waited = 0.0
            while len(got) < world_size:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue_mod.Empty:
                    waited += 1.0
                    dead = [r for r, p in enumerate(procs) if r not in got
                            and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    if waited > timeout:
                        raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(got))} "
                                           f"gave no result in {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [got[r] for r in range(world_size)]
