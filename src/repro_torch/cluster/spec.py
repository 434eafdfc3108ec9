"""ClusterSpec (``repro.cluster.spec``): WHO this process is in the
cluster, resolved from environment variables.

The launcher (``cluster.launcher``) sets these variables in each worker's
environment; a worker calls :meth:`ClusterSpec.from_env` and
:func:`initialize` before it builds a run.  On a managed cluster (SLURM,
YARN, k8s) the scheduler's wrapper sets the same variables, so nothing in
the training path knows how the processes were placed.

``REPRO_COORDINATOR``     host:port of the process group's rendezvous
                          (``tcp://``; process 0 binds it).
``REPRO_NUM_PROCESSES``   world size.
``REPRO_PROCESS_ID``      this process's rank in [0, num_processes).
``REPRO_LOCAL_DEVICES``   the members this process holds on its device
                          (``launch.mesh.ClusterMesh``: its data members and
                          their model ways, along a member dimension).  The
                          reference forces that many host devices on the
                          CPU; on its accelerator hosts the value is
                          informative only, here it is a member count.

The process group's backend is chosen from where the ranks run
(:func:`choose_backend`): **NCCL** when each rank has a card of its own,
**gloo** when ranks share a card (NCCL takes one rank a card) or run on the
CPU; over gloo the port's collectives stage a card's buffers through host
memory (``core.collectives.staged_for``).  The choice is printed on the
worker's first line, and a backend that fails to start raises: the other
one is never taken in its place.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from datetime import timedelta
from typing import Mapping, Optional, Tuple

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
ENV_LOCAL_DEVICES = "REPRO_LOCAL_DEVICES"

DEFAULT_COORDINATOR = "localhost:29400"


@dataclass(frozen=True)
class ClusterSpec:
    """One process's view of the cluster."""
    coordinator: str = DEFAULT_COORDINATOR
    num_processes: int = 1
    process_id: int = 0
    local_devices: int = 1

    def __post_init__(self):
        if self.num_processes < 1:
            raise ValueError(
                f"num_processes must be >= 1, got {self.num_processes}")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(
                f"process_id must be in [0, {self.num_processes}), "
                f"got {self.process_id}")
        if self.local_devices < 1:
            raise ValueError(
                f"local_devices must be >= 1, got {self.local_devices}")
        if ":" not in self.coordinator:
            raise ValueError(
                f"coordinator must be host:port, got {self.coordinator!r}")

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None,
                 ) -> "ClusterSpec":
        """Resolve the spec from ``env`` (default ``os.environ``); missing
        variables keep their single-process defaults, so code that calls
        this unconditionally still works outside any launcher."""
        env = os.environ if env is None else env
        return cls(
            coordinator=env.get(ENV_COORDINATOR, DEFAULT_COORDINATOR),
            num_processes=int(env.get(ENV_NUM_PROCESSES, "1")),
            process_id=int(env.get(ENV_PROCESS_ID, "0")),
            local_devices=int(env.get(ENV_LOCAL_DEVICES, "1")))

    def env(self) -> dict:
        """The env-var dict the launcher exports into a worker (inverse of
        ``from_env``)."""
        return {
            ENV_COORDINATOR: self.coordinator,
            ENV_NUM_PROCESSES: str(self.num_processes),
            ENV_PROCESS_ID: str(self.process_id),
            ENV_LOCAL_DEVICES: str(self.local_devices),
        }

    def replace(self, **kw) -> "ClusterSpec":
        return replace(self, **kw)

    @property
    def is_multiprocess(self) -> bool:
        return self.num_processes > 1


def in_worker(env: Optional[Mapping[str, str]] = None) -> bool:
    """True when this process was spawned by the cluster launcher (the
    worker env vars are present)."""
    env = os.environ if env is None else env
    return ENV_PROCESS_ID in env


# how long a member waits for a peer in a collective before it raises: the
# supervisor ends a group with a dead member long before (its heartbeat
# timeout), so this only bounds a group nobody supervises
COLLECTIVE_TIMEOUT_S = 600.0


def ranks_share_cards(num_processes: int) -> bool:
    """True when ``num_processes`` ranks on this host's cards must share
    them (rank r on ``cuda:(r % cards)``)."""
    import torch
    return num_processes > torch.cuda.device_count()


def choose_backend(spec: ClusterSpec, device=None) -> Tuple[str, str]:
    """(backend, why) of the process group of ``spec``'s ranks on
    ``device`` (None: the GPU, rank r on ``cuda:(r % cards)``, as
    ``launch.mesh.make_cluster_mesh`` places it)."""
    import torch

    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "gloo", f"ranks on the {dev.type}"
    cards = torch.cuda.device_count()
    if ranks_share_cards(spec.num_processes):
        return "gloo", (f"{spec.num_processes} ranks share {cards} card(s), "
                        "and NCCL takes one rank a card: messages staged "
                        "through host memory")
    return "nccl", f"{spec.num_processes} ranks, one card each"


def initialize(spec: ClusterSpec, device=None) -> str:
    """Join this process to the process group of ``spec`` (a rendezvous at
    ``tcp://<coordinator>``, this rank, the world size and
    ``COLLECTIVE_TIMEOUT_S``) over :func:`choose_backend`'s backend, and
    return a line that says which and why.  A one-process spec does
    nothing: a single process needs no group, and the world-1 floor of the
    elastic supervisor keeps no rendezvous port open.  A backend that is
    missing or fails to start raises."""
    if not spec.is_multiprocess:
        return "1 process (no process group)"
    import torch
    import torch.distributed as dist
    backend, why = choose_backend(spec, device)
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError(
                f"the process group needs NCCL ({why}), and this torch has "
                "none")
        torch.cuda.set_device(spec.process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{spec.coordinator}",
        rank=spec.process_id, world_size=spec.num_processes,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return (f"{spec.num_processes} processes over {backend} ({why}; process "
            f"group at tcp://{spec.coordinator})")
