"""Process meshes for the sharded paths: one process (rank) per device.

Counterpart of ``dataset_pipeline_tpu/parallel/mesh.py``. The JAX package
runs one program over a ``Mesh`` of devices (one process per host) and sums
with ``psum`` inside ``shard_map``. The port runs one process per device:
every rank sees the whole problem, computes on its shard of the rows
(correspondences, images, frames), and meets the other ranks in
``torch.distributed`` collectives: ``all_reduce`` where JAX ``psum``s and
``all_gather`` where JAX leaves an output sharded and then fetches it. Every
rank ends with the same small replicated system, solves it and applies the
same update, as every JAX device does.

The backend is a rule, not a recovery: NCCL when every rank runs on a card
of its own, Gloo when the ranks run on the CPU or share a card (NCCL takes
one rank per card). The computation stays on the rank's device under either
backend; Gloo's CUDA support covers ``all_reduce`` and ``all_gather``, the
two collectives used here.

A world of one needs no process group: every collective on a ``Mesh``
without one is the identity. ``launch`` starts the ranks of one host itself
(the CLIs' ``--devices N`` without the ``DPT_*`` environment).
"""

from __future__ import annotations

import math
import os
import queue
import socket
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dataset_pipeline_tpu_torch import default_device

# a rank that waits longer than this in a collective or the rendezvous raises
# (a rank may wait out another's whole set-up, e.g. the cloud cache's build)
TIMEOUT = timedelta(minutes=60)


@dataclass
class Mesh:
    """The ranks of a run laid out on named axes (``("data",)`` or
    ``("hosts", "devices")``), this rank's place in it and its device.
    ``backend`` is the process group's (``"nccl"`` / ``"gloo"``), or None
    for a world of one without a process group. Collectives span every
    axis, as JAX's default ``axis`` does; ``calls`` and ``seconds`` count
    them (the device synchronized around each)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    device: torch.device
    backend: Optional[str]
    calls: int = 0
    seconds: float = 0.0

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _collective(self, op, *tensors):
        self._sync()
        t0 = time.perf_counter()
        op(*tensors)
        self._sync()
        self.seconds += time.perf_counter() - t0
        self.calls += 1

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (a new tensor)."""
        if self.backend is None:
            return x
        y = x.contiguous().clone()
        self._collective(dist.all_reduce, y)
        return y

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes), concatenated in rank order
        along the leading axis."""
        if self.backend is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._collective(dist.all_gather, parts, x)
        return torch.cat(parts)

    def barrier(self) -> None:
        if self.backend is not None:
            dist.barrier()


def as_mesh(mesh_or_device) -> Mesh:
    """A ``Mesh`` as it is; a device (or its name, or None for the card) as a
    one-rank mesh on it, whose collectives are the identity."""
    if isinstance(mesh_or_device, Mesh):
        return mesh_or_device
    return Mesh(("data",), (1,), 0, default_device(mesh_or_device), None)


def rank_device(rank: int, device=None) -> torch.device:
    """Rank ``rank``'s device: the CPU when ``device`` names it, else
    ``cuda:(rank % torch.cuda.device_count())`` (raising without CUDA)."""
    dev = default_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def env_configured() -> bool:
    """Whether the ``DPT_*`` environment names a distributed run."""
    return "DPT_COORDINATOR" in os.environ or "DPT_NUM_PROCESSES" in os.environ


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device=None) -> bool:
    """Join the run's process group; call once per rank before any collective.

    Configuration comes from the arguments or the ``DPT_COORDINATOR`` /
    ``DPT_NUM_PROCESSES`` / ``DPT_PROCESS_ID`` environment, as in the JAX
    package. The coordinator is ``host:port`` (a TCP store that rank 0
    serves) or ``file:///path`` (a file store, for ranks of one host). The
    ranks first tell each other their devices through the store, then form
    the group with NCCL if each has a card of its own, else with Gloo.
    ``device`` names the rank's device kind (``"cpu"``, or the card by
    default); a CUDA rank takes ``rank_device`` as its current device.

    Returns False and changes nothing when no coordinator is configured (the
    single-process path), True when a group exists (also when it already
    did)."""
    coordinator_address = coordinator_address or os.environ.get("DPT_COORDINATOR")
    if num_processes is None and "DPT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DPT_NUM_PROCESSES"])
    if process_id is None and "DPT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DPT_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a distributed run needs the coordinator address, the number of "
                         "processes and this process's id (DPT_COORDINATOR, "
                         "DPT_NUM_PROCESSES, DPT_PROCESS_ID)")
    world, rank = int(num_processes), int(process_id)
    if coordinator_address.startswith("file://"):
        store = dist.FileStore(coordinator_address[len("file://"):], world)
    else:
        host, port = coordinator_address.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=TIMEOUT)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        place = f"{socket.gethostname()}/cuda:{dev.index}"
    else:
        place = "cpu"
    store.set(f"dpt_device/{rank}", place)
    places = [store.get(f"dpt_device/{r}").decode() for r in range(world)]
    own_card = "cpu" not in places and len(set(places)) == world
    dist.init_process_group("nccl" if own_card else "gloo", store=store, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    return True


def _world() -> Tuple[int, int, Optional[str]]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.get_backend()
    return 1, 0, None


def make_data_mesh(n_devices: Optional[int] = None, axis: str = "data", device=None) -> Mesh:
    """The 1-D mesh over every rank of the run (one rank without a process
    group). ``n_devices`` must be the world size (or None / 0): a rank
    outside the mesh would have no work."""
    world, rank, backend = _world()
    if n_devices and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices in a world of {world} ranks")
    return Mesh((axis,), (world,), rank, rank_device(rank, device), backend)


def make_host_device_mesh(num_hosts: Optional[int] = None, devices_per_host: Optional[int] = None,
                          axes: Sequence[str] = ("hosts", "devices"), device=None) -> Mesh:
    """The 2-axis mesh: the leading axis across hosts, the trailing within
    a host, ranks numbered host-major. JAX's default ``num_hosts`` is
    ``jax.process_count()``, one process per host; the port runs one
    process per device, so it takes one host unless ``num_hosts`` is given,
    and ``devices_per_host`` defaults to the world over ``num_hosts``. The
    product must be the world size."""
    world, rank, backend = _world()
    num_hosts = num_hosts or 1
    devices_per_host = devices_per_host or world // num_hosts
    if num_hosts * devices_per_host != world:
        raise ValueError(f"mesh {num_hosts}x{devices_per_host} needs "
                         f"{num_hosts * devices_per_host} ranks, the world has {world}")
    return Mesh(tuple(axes), (num_hosts, devices_per_host), rank, rank_device(rank, device),
                backend)


def mesh_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def padded_rows(n: int, mesh: Mesh) -> int:
    """``n`` rounded up to a multiple of the mesh size."""
    return -(-n // mesh.size) * mesh.size


def shard_range(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous share of ``n`` rows (``n`` a multiple of the
    mesh size)."""
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_rows(mesh: Mesh, x) -> torch.Tensor:
    """This rank's contiguous slice of the leading axis of ``x`` (a tensor
    or a numpy array) on the rank's device, after padding the axis with zero
    rows to a multiple of the mesh size. Zero rows carry ``w = 0``, which the
    sharded sums require of padding (the JAX docstrings' rule)."""
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    n = x.shape[0]
    pad = padded_rows(n, mesh) - n
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x[shard_range(mesh, n + pad)].to(mesh.device)


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """``x`` whole on the rank's device."""
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(mesh.device)


# ---------------------------------------------------------------------------
# The ranks of one host, started by a caller
# ---------------------------------------------------------------------------


def parse_topology(text: str) -> Tuple[int, int]:
    """``"HxD"`` -> (hosts, devices per host)."""
    try:
        h, d = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh must be HxD (hosts x devices), got {text!r}") from None
    if h < 1 or d < 1:
        raise SystemExit(f"--mesh {text}: both factors must be >= 1")
    return h, d


def ranks_to_launch(devices: int, topology: str, device) -> int:
    """How many ranks a CLI starts on this host: 0 when the ``DPT_*``
    environment says that the ranks run already, or when one device is
    asked for; else ``--mesh`` H x D, or ``--devices`` N (0 = every card of
    the host, one on the CPU)."""
    if env_configured():
        return 0
    if topology:
        h, d = parse_topology(topology)
        n = h * d
    elif devices == 0:
        n = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    else:
        n = devices
    return n if n > 1 else 0


def cli_mesh(devices: int, topology: str, device) -> Optional[Mesh]:
    """The mesh of a CLI's process: None for one device and no ``DPT_*``
    environment (the single-device path), else this rank's mesh, after it
    joined the group. Under ``DPT_*``, ``--devices`` must be 0 or the world
    size, and ``--mesh`` H x D must cover the world."""
    if not initialize_distributed(device=device):
        return None
    world = dist.get_world_size()
    if topology:
        h, d = parse_topology(topology)
        if h * d != world:
            raise SystemExit(f"--mesh {topology} needs {h * d} ranks; the run has {world}")
        return make_host_device_mesh(h, d, device=device)
    if devices not in (0, world):
        raise SystemExit(f"--devices {devices} in a run of {world} ranks: pass 0 or {world}")
    return make_data_mesh(world, device=device)


def _rank_main(fn, args, rank: int, world: int, coordinator: str, threads: int, results):
    """One rank of ``launch``: the ``DPT_*`` environment, then ``fn(*args)``;
    its result and kernel launches (or its traceback) go to ``results``.
    Ranks other than 0 print nothing to stdout."""
    os.environ.update(DPT_COORDINATOR=coordinator, DPT_NUM_PROCESSES=str(world),
                      DPT_PROCESS_ID=str(rank))
    torch.set_num_threads(threads)
    if rank:
        sys.stdout = open(os.devnull, "w")
    from dataset_pipeline_tpu_torch import kernels

    try:
        out = fn(*args)
        results.put((rank, True, (out, dict(kernels.LAUNCHES))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world: int, args: tuple = (), device=None) -> list:
    """Run ``fn(*args)`` in ``world`` new processes (the ``spawn`` start
    method: this process may hold CUDA state), rank ``r`` with the ``DPT_*``
    environment of a ``world``-rank run over a file rendezvous, and return
    ``(result, kernel launches)`` of each rank in rank order. Each rank takes
    an equal share of this process's CPU threads. Each rank's kernel
    launches are also added to this process's ``kernels.LAUNCHES``, so a
    caller that reads the counts around the call sees its ranks' launches.

    ``fn`` and ``args`` must pickle (a module-level function). A rank that
    raises or dies stops the others and raises here with its traceback.
    ``device`` is the ranks' device: when it names the card, the kernel
    library is built here first, so that the ranks load it instead of each
    building it."""
    from dataset_pipeline_tpu_torch import kernels

    if device is not None and torch.device(device).type == "cuda":
        kernels.library()

    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory(prefix="dpt_ranks_") as tmp:
        coordinator = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, world, coordinator, threads, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        try:
            while len(got) < world:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                try:
                    # a rank that died has had a moment to post its traceback
                    rank, ok, payload = results.get(timeout=5.0 if dead else 1.0)
                except queue.Empty:
                    if dead:
                        raise RuntimeError(f"rank(s) exited without a result: {dead}") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
                got[rank] = payload
            for p in procs:
                p.join(60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(10)
    for _, launches in got.values():
        for k, v in launches.items():
            kernels.LAUNCHES[k] += v
    return [got[r] for r in range(world)]

