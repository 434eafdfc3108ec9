"""Gradient communication (``repro.comm``): bucketed, hierarchical
part-reduce / part-broadcast, paper §3.2-§3.4.

:mod:`~repro_torch.comm.bucketer` owns the static bucket plan and the
pack/unpack of leaves into fusion buffers; :mod:`~repro_torch.comm.schedule`
the flat and hierarchical schedules over a mesh (``launch.mesh``);
:mod:`~repro_torch.comm.backends` the wire collectives they drive (``lax``,
the plain collectives, ``pallas-ring``, the §3.4 ring on the port's CUDA
kernels, and ``gossip``, the rotating partner exchange), fp32 and bf16 or
compressed (int8, top-k);
:mod:`~repro_torch.comm.overlap` the §3.1 backprop-overlap taps (each
bucket's reduce issued inside the backward pass, on a side CUDA stream) and
the bucket -> layer readiness metadata.  The consumers are
``optim.dist.make_distributed_update``, ``make_topk_ef_update`` and
``make_overlapped_update`` and ``make_stale_sync_update`` and, through
them, ``train.make_train_step(dist_update=...)`` and
``train.make_overlapped_train_step``.  ``comm="auto"`` picks the bucket
size, backend and wire format from measured collectives
(``telemetry.autotune``).
"""
from repro_torch.comm.backends import (  # noqa: F401
    COLLECTIVE_BACKENDS,
    CollectiveBackend,
    GossipBackend,
    LaxBackend,
    RingBackend,
    get_backend,
)
from repro_torch.comm.bucketer import (  # noqa: F401
    WIRE_FORMATS,
    Bucket,
    BucketPlan,
    CommConfig,
    LeafSlot,
    pack_bucket,
    plan_buckets,
    unpack_buckets,
)
from repro_torch.comm.overlap import (  # noqa: F401
    bucket_triggers,
    exposed_comm,
    issue_order,
    make_overlap_grad,
)
from repro_torch.comm.schedule import (  # noqa: F401
    FlatSchedule,
    HierarchicalSchedule,
    group_axes,
    make_schedule,
)
