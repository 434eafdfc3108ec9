"""comm_ms: device ms a step of the ring kernels and NCCL's on rank 0 in
the trace (the zero1 update's exchange and its folds)."""


def read(obs):
    return obs["trace"].ms_per_step("comm")
