"""Hand-written Hopper kernels of the port (``csrc/``), each beside its plain
PyTorch version, and the build that compiles them at first use."""


def launch_counts() -> dict:
    """Every wrapper's kernel launches in this process since the last
    :func:`reset_launch_counts` (or since import): a wrapper counts a call
    where it launches its kernel, never where it runs its plain version."""
    from repro_torch.kernels import blocked_matmul, conv2d, flash_attention
    from repro_torch.kernels import paged_attn, ring
    return {"blocked_matmul": blocked_matmul.launches,
            "conv2d_nhwc": conv2d.launches,
            "paged_decode_attention": paged_attn.launches,
            "flash_attention": flash_attention.launches, **ring.launches}


def reset_launch_counts() -> None:
    from repro_torch.kernels import blocked_matmul, conv2d, flash_attention
    from repro_torch.kernels import paged_attn, ring
    ring.reset_launches()
    blocked_matmul.launches = conv2d.launches = paged_attn.launches = 0
    flash_attention.launches = 0
