"""dnn_bwd_ms: device ms a step of the cuBLAS kernels (the DNN's backward
products) in the trace."""


def read(obs):
    return obs["trace"].ms_per_step("cublas")
