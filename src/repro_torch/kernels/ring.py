"""The paper's §3.4 ring collectives: the Hopper kernels and their plain
PyTorch versions.

Port of ``repro.kernels.ring``'s three dense kernels; the CUDA source,
``csrc/ring.cu``, states their design and bound.

:func:`ring_hop_accum`       one hop of the distributed ring: ``recv +
                             chunks[c]`` (the process mesh's combine after
                             each neighbour receive).
:func:`ring_reduce_scatter`  the stacked single-device ring over a
                             ``(G, N)`` buffer, member p's partial in row p:
                             row p of the ``(G, N / G)`` result is the fully
                             reduced chunk p (the local mesh's part-reduce).
:func:`ring_all_gather`      ``(G, n)`` strips to ``(G, G * n)``, every row
                             the strips in owner order (its part-broadcast).

Each wrapper computes its plain version on CPU tensors (that is how the CPU
tests run it) and on CUDA tensors launches its kernel or raises; it never
falls back.  The ``*_plain`` functions repeat the kernels' arithmetic in the
same order and dtype, so a kernel agrees with its plain version bitwise.
Additions happen in the input dtype, as in the reference: the ring's hop
adds are the wire arithmetic.
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset, per wrapper (the plain versions are
# not counted); ring_reduce_scatter launches its hop kernel G - 1 times a call
launches = {"ring_hop_accum": 0, "ring_reduce_scatter": 0,
            "ring_all_gather": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _chunk_index(c: Union[int, torch.Tensor], device) -> torch.Tensor:
    if isinstance(c, torch.Tensor):
        return c.reshape(1).to(device=device, dtype=torch.long)
    return torch.tensor([c], dtype=torch.long, device=device)


def ring_hop_accum_plain(chunks: torch.Tensor, recv: torch.Tensor,
                         c: Union[int, torch.Tensor]) -> torch.Tensor:
    """``recv + chunks[c]`` in the input dtype; ``c`` an int or a
    one-element int tensor (read without a host sync)."""
    return recv + chunks.index_select(
        0, _chunk_index(c, chunks.device))[0]


def ring_reduce_scatter_plain(stacked: torch.Tensor) -> torch.Tensor:
    """The stacked ring replayed step by step: at step s member p adds its
    own chunk ``(p - 2 - s) % G`` to what member p - 1 sent it (its raw
    chunk at s = 0); after G - 1 steps row p holds the sum of chunk p,
    added in the ring's order and in the input dtype."""
    G, N = stacked.shape
    n = N // G
    if G == 1:
        return stacked.reshape(1, N)
    x = stacked.reshape(G, G, n)
    p = torch.arange(G, device=stacked.device)
    acc = x[(p - 1) % G, (p - 2) % G]
    for s in range(G - 1):
        if s:
            acc = torch.roll(acc, 1, dims=0)
        acc = acc + x[p, (p - 2 - s) % G]
    return acc


def ring_all_gather_plain(strips: torch.Tensor) -> torch.Tensor:
    """Every member's row is the G strips in owner order (a view)."""
    G = strips.shape[0]
    return strips.reshape(1, -1).expand(G, -1)


def _check_rows(name: str, x: torch.Tensor, dim: int = 2) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != dim:
        raise ValueError(f"{name} must have {dim} dimensions, got shape "
                         f"{tuple(x.shape)}")
    if x.numel() and x.stride(-1) != 1:
        raise ValueError(f"{name}'s rows must be contiguous, got strides "
                         f"{x.stride()}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} must lie on cuda or cpu, got {x.device}")


def ring_hop_accum(chunks: torch.Tensor, recv: torch.Tensor,
                   c: Union[int, torch.Tensor]) -> torch.Tensor:
    """One ring hop: this member's chunk ``c`` of ``chunks`` (G, n) added to
    the partial ``recv`` (n,) just received from the left neighbour.  ``c``
    is a Python int in ``[0, G)`` or a one-element int32 tensor on the same
    device, which the kernel reads on the card (taken mod G) so that no hop
    waits for the host."""
    _check_rows("chunks", chunks)
    _check_rows("recv", recv, dim=1)
    G, n = chunks.shape
    if recv.dtype != chunks.dtype or recv.device != chunks.device:
        raise ValueError(f"recv ({recv.dtype}, {recv.device}) must match "
                         f"chunks ({chunks.dtype}, {chunks.device})")
    if recv.shape[0] != n or n == 0:
        raise ValueError(f"recv {tuple(recv.shape)} must be one non-empty "
                         f"chunk of chunks {tuple(chunks.shape)}")
    if isinstance(c, torch.Tensor):
        if c.numel() != 1 or c.dtype != torch.int32 or c.device != chunks.device:
            raise ValueError(f"c must be one int32 on {chunks.device}, got "
                             f"{c.dtype} {tuple(c.shape)} on {c.device}")
    elif not 0 <= int(c) < G:
        raise ValueError(f"chunk index {c} outside [0, {G})")
    if chunks.device.type == "cpu":
        return ring_hop_accum_plain(chunks, recv, c)
    out = torch.empty_like(recv)
    tensor_c = isinstance(c, torch.Tensor)
    _launch_hop(recv, 0, 0, 0, chunks, 0, chunks.stride(0), out, 0, 0,
                c.data_ptr() if tensor_c else None, 0 if tensor_c else int(c),
                G, 1, n)
    launches["ring_hop_accum"] += 1
    return out


def ring_reduce_scatter(stacked: torch.Tensor) -> torch.Tensor:
    """Reduce-scatter a stacked ``(G, N)`` buffer of per-member partials:
    row p of the ``(G, N // G)`` result is the fully reduced chunk p,
    member p's strip under the §3.4 owner convention.  ``N % G == 0``.  The
    member stride may be anything, 0 included (one buffer viewed G times)."""
    _check_rows("stacked", stacked)
    G, N = stacked.shape
    if G < 1 or N % G:
        raise ValueError(f"buffer size {N} not divisible by group {G}")
    if G == 1:
        return stacked.reshape(1, N)
    if stacked.device.type == "cpu":
        return ring_reduce_scatter_plain(stacked)
    n = N // G
    xs = stacked.stride(0)
    out = stacked.new_empty(G, n)
    box = stacked.new_empty(2, G, n) if G > 2 else None
    for s in range(G - 1):
        if s == 0:      # the left neighbour sends its raw chunk
            a, a_ms, a_cs, a_shift = stacked, xs, n, -1
        else:
            a, a_ms, a_cs, a_shift = box[s % 2], n, 0, 0
        if s == G - 2:  # the last hop lands in the owner's row
            o, o_shift = out, 0
        else:           # send to the right neighbour's mailbox
            o, o_shift = box[(s + 1) % 2], 1
        _launch_hop(a, a_ms, a_cs, a_shift, stacked, xs, n, o, n, o_shift,
                    None, -2 - s, G, G, n)
        launches["ring_reduce_scatter"] += 1
    return out


def ring_all_gather(strips: torch.Tensor) -> torch.Tensor:
    """All-gather per-member ``(G, n)`` strips into ``(G, G * n)``: every
    row is the full buffer, strips concatenated in owner order (the §3.4
    part-broadcast).  Exact in any dtype."""
    _check_rows("strips", strips)
    G, n = strips.shape
    if G == 1:
        return strips
    if n == 0:
        raise ValueError("strips must not be empty")
    if strips.device.type == "cpu":
        return ring_all_gather_plain(strips)
    out = strips.new_empty(G, G * n)
    es = strips.element_size()
    with torch.cuda.device(strips.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().ring_all_gather(strips.data_ptr(), strips.stride(0) * es,
                                    out.data_ptr(), G, n * es, stream)
    if rc != 0:
        raise RuntimeError(f"ring_all_gather launch failed: CUDA error {rc}")
    launches["ring_all_gather"] += 1
    return out


def _launch_hop(a, a_ms, a_cs, a_shift, b, b_ms, b_cs, out, o_ms, o_shift,
                c_ptr, c_shift, G, M, n) -> None:
    if out.device.type != "cuda":
        raise ValueError(f"the ring kernels run on cuda, got {out.device}")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().ring_hop(_DTYPES[out.dtype], a.data_ptr(), a_ms, a_cs,
                             a_shift, b.data_ptr(), b_ms, b_cs,
                             out.data_ptr(), o_ms, o_shift, c_ptr, c_shift,
                             G, M, n, stream)
    if rc != 0:
        raise RuntimeError(f"ring hop launch failed: CUDA error {rc}")


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("ring")
    if lib.ring_hop.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ring_hop.argtypes = [i, p, ll, ll, i, p, ll, ll, p, ll, i, p, i,
                                 i, i, ll, p]
        lib.ring_hop.restype = ctypes.c_int
        lib.ring_all_gather.argtypes = [p, ll, p, i, ll, p]
        lib.ring_all_gather.restype = ctypes.c_int
    return lib
