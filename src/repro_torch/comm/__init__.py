"""Gradient communication (``repro.comm``): bucketed, hierarchical
part-reduce / part-broadcast, paper §3.2-§3.4.

:mod:`~repro_torch.comm.bucketer` owns the static bucket plan and the
pack/unpack of leaves into fusion buffers; :mod:`~repro_torch.comm.schedule`
the flat and hierarchical schedules over a mesh (``launch.mesh``);
:mod:`~repro_torch.comm.backends` the wire collectives they drive (``lax``,
the plain collectives, and ``pallas-ring``, the §3.4 ring on the port's
CUDA kernels), fp32 and bf16 or compressed (int8, top-k).  The consumers
are ``optim.dist.make_distributed_update`` and ``make_topk_ef_update`` and,
through them, ``train.make_train_step(dist_update=...)``.  Backprop overlap
and ``comm="auto"`` are not ported yet.
"""
from repro_torch.comm.backends import (  # noqa: F401
    COLLECTIVE_BACKENDS,
    CollectiveBackend,
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
from repro_torch.comm.schedule import (  # noqa: F401
    FlatSchedule,
    HierarchicalSchedule,
    group_axes,
    make_schedule,
)
