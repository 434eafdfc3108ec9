"""``repro_torch.api`` — the training and serving seams of the port:

    from repro_torch.api import RunSpec, compile_run
    run = compile_run(RunSpec(arch="vgg-a", steps=6, batch=64))   # on the GPU
    history = run.fit()

    # the §3.4 zero1 update of G = 4 members on one device, the ring kernels
    from repro_torch.api import MeshSpec
    from repro_torch.comm import CommConfig
    run = compile_run(RunSpec(arch="vgg-a", parallel="zero1",
                              comm=CommConfig(backend="pallas-ring"),
                              mesh=MeshSpec(members_per_device=4)))

    # the paper's §3.3 hybrid: 2 data members x 2 model ways on one card,
    # each model member's products on its own columns (dp, zero1-gspmd or
    # zero1); run.full_params() is the full tree
    run = compile_run(RunSpec(arch="cd-dnn", parallel="dp",
                              mesh=MeshSpec(members_per_device=2,
                                            model_ways=2)))

    # one member a process of the gloo group that ``python -m
    # repro_torch.launch.cluster --processes N`` starts; a ckpt_dir run
    # checkpoints and resumes, at another world size too
    run = compile_run(RunSpec(arch="vgg-a", parallel="zero1",
                              mesh=MeshSpec(cluster=True),
                              ckpt_every=2, ckpt_dir="/tmp/ckpt"))

    from repro_torch.api import ServeSpec, compile_serve
    server = compile_serve(ServeSpec(arch="llama3-8b"))     # on the GPU
    rid = server.submit([1, 2, 3]); done = server.drain()
"""
from repro_torch.api.assemble import compile_run, compile_serve  # noqa: F401
from repro_torch.api.families import FamilyAdapter, adapter_for  # noqa: F401
from repro_torch.api.run import Run  # noqa: F401
from repro_torch.api.serve import Request, Server  # noqa: F401
from repro_torch.api.spec import (  # noqa: F401
    COMM_MODES,
    MODE_CAPS,
    OPTIMIZERS,
    PAGED_ATTN_IMPLS,
    PARALLEL_MODES,
    SCHEDULER_POLICIES,
    SCHEDULES,
    MeshSpec,
    ModeCaps,
    RunSpec,
    ServeSpec,
    TelemetrySpec,
)
