"""``repro_torch.api`` — the serving seam of the port:

    from repro_torch.api import ServeSpec, compile_serve
    server = compile_serve(ServeSpec(arch="llama3-8b"))     # on the GPU
    rid = server.submit([1, 2, 3]); done = server.drain()
"""
from repro_torch.api.assemble import compile_serve  # noqa: F401
from repro_torch.api.serve import Request, Server  # noqa: F401
from repro_torch.api.spec import (  # noqa: F401
    PAGED_ATTN_IMPLS,
    SCHEDULER_POLICIES,
    ServeSpec,
)
