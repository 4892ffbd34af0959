"""Process bring-up for data-parallel training, one process per card: the
JAX package's ``launch/pod.py`` (``jax.distributed.initialize``) as a
``torch.distributed`` process group.

A process joins a world as its :class:`DistributedConfig` says:

- ``auto``: from the environment that ``torchrun`` gives each process it
  starts (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), read when the world is joined, never at import: the
  counterpart of ``jax.distributed.initialize()`` from TPU metadata;
- explicit: ``coordinator_address`` (``host:port``, whose TCP store rank 0
  serves, or a ``tcp://`` or ``file://`` URL), ``num_processes`` and
  ``process_id``, with ``local_rank`` (default: the process id) naming the
  card;
- neither: one process and no group; :func:`initialize_distributed`
  returns None and the callers run exactly as they do without a world.

The backend follows the device, NCCL for ``cuda`` and gloo for ``cpu``;
``backend`` picks one (gloo over CUDA tensors runs two ranks on one card,
which NCCL refuses).  The group is made with a finite ``timeout_s``, so a
rank whose peers are gone raises instead of waiting for ever.

The code that runs in a world takes it from the :class:`World` object it is
handed, never from ``torch.distributed.is_initialized()``.
:func:`run_local_world` is the launcher behind ``--num-devices N``: N
processes of one command line on this host, one a card, meeting through a
file store in a temporary directory.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections.abc import Mapping, Sequence
from typing import Any

import torch
import torch.distributed as dist

from batchai_retinanet_horovod_coco_tpu_torch.parallel.mesh import rank_device

#: The variables ``torchrun`` sets in each process it starts.
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
_BACKENDS = {"nccl": "is_nccl_available", "gloo": "is_gloo_available"}


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """How to join a multi-process world, or (the default) not to."""

    auto: bool = False
    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None
    local_rank: int | None = None
    device: str = "cuda"
    backend: str | None = None  # None: nccl for cuda, gloo for cpu
    timeout_s: float = 600.0

    @property
    def joins(self) -> bool:
        return self.auto or self.coordinator_address is not None

    def resolved(self, environ: Mapping[str, str] | None = None) -> DistributedConfig:
        """Every field explicit: ``auto`` reads torchrun's variables from
        ``environ`` (default ``os.environ``), and the init method becomes
        ``env://``.  Raises, naming the cause, on a missing variable or an
        incomplete or out-of-range explicit world."""
        if self.auto:
            env = os.environ if environ is None else environ
            missing = [k for k in TORCHRUN_ENV if k not in env]
            if missing:
                raise RuntimeError(
                    f"--distributed-auto: {', '.join(missing)} not set; start the processes "
                    "with torchrun, or join explicitly with --coordinator-address, "
                    "--num-processes and --process-id"
                )
            config = dataclasses.replace(
                self, coordinator_address="env://", num_processes=int(env["WORLD_SIZE"]),
                process_id=int(env["RANK"]), local_rank=int(env["LOCAL_RANK"]),
            )
        else:
            if self.coordinator_address is None or self.num_processes is None \
                    or self.process_id is None:
                raise ValueError(
                    "an explicit world needs --coordinator-address, --num-processes and "
                    "--process-id together"
                )
            config = self
        if config.num_processes < 1 or not 0 <= config.process_id < config.num_processes:
            raise ValueError(
                f"process id {config.process_id} is not in a world of {config.num_processes}"
            )
        if config.local_rank is None:
            config = dataclasses.replace(config, local_rank=config.process_id)
        return config

    @property
    def init_method(self) -> str:
        address = self.coordinator_address or ""
        return address if "://" in address else f"tcp://{address}"

    def backend_name(self) -> str:
        return self.backend or ("nccl" if torch.device(self.device).type == "cuda" else "gloo")


@dataclasses.dataclass(frozen=True)
class World:
    """A joined world as one of its processes sees it."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str
    # The model replica of the train step (parallel/mesh.py::replicate),
    # one at a time.
    replica_slot: list = dataclasses.field(default_factory=list, compare=False, repr=False)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def comm_device(self) -> torch.device:
        """Where this world's own collectives put their tensors: the card
        for NCCL, the host for gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``tensor`` over the ranks in place (``sum`` or ``max``),
        through :attr:`comm_device`; returns it."""
        reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if tensor.device == self.comm_device:
            dist.all_reduce(tensor, op=reduce_op)
            return tensor
        staged = tensor.to(self.comm_device)
        dist.all_reduce(staged, op=reduce_op)
        return tensor.copy_(staged)

    def broadcast_int(self, value: int) -> int:
        """Rank 0's ``value`` on every rank."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.comm_device)
        dist.broadcast(t, src=0)
        return int(t.item())

    def all_gather(self, tensor: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``tensor`` (the same shape on each), in rank order,
        on :attr:`comm_device`."""
        tensor = tensor.to(self.comm_device).contiguous()
        out = [torch.empty_like(tensor) for _ in range(self.size)]
        dist.all_gather(out, tensor)
        return out


def initialize_distributed(config: DistributedConfig = DistributedConfig()) -> World | None:
    """Join the world ``config`` describes and return it; None (no group)
    for a single process.  Raises, naming the backend, where this build of
    PyTorch lacks it, and, naming the card, where ``cuda:<local rank>`` is
    not there."""
    if not config.joins:
        return None
    config = config.resolved()
    device = rank_device(config.local_rank, config.device)
    backend = config.backend_name()
    if backend not in _BACKENDS:
        raise ValueError(f"unsupported backend {backend!r}; one of {sorted(_BACKENDS)}")
    if not dist.is_available() or not getattr(dist, _BACKENDS[backend])():
        raise RuntimeError(
            f"the {backend} backend of torch.distributed is not available in this PyTorch "
            f"build; a world on {config.device} needs it"
        )
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=config.init_method, rank=config.process_id,
        world_size=config.num_processes, timeout=datetime.timedelta(seconds=config.timeout_s),
    )
    return World(rank=config.process_id, size=config.num_processes,
                 local_rank=config.local_rank, device=device, backend=backend)


def shutdown_distributed(world: World | None) -> None:
    """Destroy the world's process group (nothing for None)."""
    if world is not None and dist.is_initialized():
        world.replica_slot.clear()
        dist.destroy_process_group()


def shard_info(world: World | None) -> tuple[int, int]:
    """``(shard_index, shard_count)`` of the host data: rank r reads
    ``records[r::size]``."""
    return (0, 1) if world is None else (world.rank, world.size)


def run_local_world(module: str, argv: Sequence[str], num_processes: int) -> list[dict[str, Any]]:
    """Run ``python -m <module> <argv>`` as ranks 0..N-1 of one world on
    this host (the explicit flags ``--coordinator-address file://...
    --num-processes N --process-id r`` added) and wait for all of them.
    A rank that exits non-zero stops the others, and this raises naming
    it.  Returns each rank's result: the JSON object its command line
    wrote to the file named by ``--world-result``."""
    tmp = tempfile.mkdtemp(prefix="retinanet-world-")
    package_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (package_root, env.get("PYTHONPATH")) if p)
    procs: list[subprocess.Popen] = []
    try:
        for rank in range(num_processes):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv,
                 "--coordinator-address", f"file://{os.path.join(tmp, 'store')}",
                 "--num-processes", str(num_processes), "--process-id", str(rank),
                 "--world-result", os.path.join(tmp, f"result-{rank}.json")],
                env=env,
            ))
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(
                    "rank " + ", rank ".join(f"{r} exited with code {c}" for r, c in failed)
                    + f"; the other ranks of the world of {num_processes} were stopped"
                )
            if all(c == 0 for c in codes):
                break
            time.sleep(0.2)
        results = []
        for rank in range(num_processes):
            with open(os.path.join(tmp, f"result-{rank}.json")) as f:
                results.append(json.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
