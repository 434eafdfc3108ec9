"""The cluster subsystem of the port (``repro.cluster``): launch over
``torch.distributed`` and elastic fault tolerance.

``cluster.spec``      :class:`ClusterSpec`, who this process is (from the
                      ``REPRO_*`` environment variables), and
                      :func:`initialize`, which joins the process group
                      (NCCL with a card a rank, else gloo).
``cluster.launcher``  the localhost launcher: spawns N workers of ``python
                      -m repro_torch.launch.cluster``, streams their output
                      and watches their heartbeats.
``cluster.elastic``   the supervisor: on a dead worker (exit or heartbeat
                      stall) it kills the group and relaunches it over the
                      survivors (or at full size under ``grow_back``); the
                      workers resume from the latest checkpoint with the
                      zero1 strips re-planned for the new world size.

Training itself needs no cluster code: ``RunSpec(mesh=MeshSpec(
cluster=True))`` makes ``compile_run`` build the mesh over the live
process group (``launch.mesh.make_cluster_mesh``).
"""
from repro_torch.cluster.elastic import (  # noqa: F401
    ChaosSpec,
    ElasticResult,
    run_elastic,
)
from repro_torch.cluster.launcher import (  # noqa: F401
    WorkerHandle,
    free_port,
    spawn_workers,
)
from repro_torch.cluster.spec import (  # noqa: F401
    ENV_COORDINATOR,
    ENV_LOCAL_DEVICES,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    ClusterSpec,
    choose_backend,
    in_worker,
    initialize,
)
