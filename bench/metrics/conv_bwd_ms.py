"""conv_bwd_ms: device ms a step of the cuDNN kernels (the backward
convolutions) in the trace."""


def read(obs):
    return obs["trace"].ms_per_step("cudnn")
