"""gemm_fwd_roofline: the least time of the forward products at this
rank's rows (``flops.least_seconds``, each product alone), over the GEMM
kernel's device time a step in the trace; in %."""


def read(obs):
    kernel_ms = obs["trace"].ms_per_step("gemm_kernel")
    if kernel_ms is None:
        return None
    f, cell = obs["flops"], obs["cell"]
    least_ms = 1e3 * sum(f.least_seconds(p, obs["rows"])
                         for p in cell.family.products(cell.config)
                         if p[0] == "fc")
    return 100.0 * least_ms / kernel_ms
