"""The paper's §3.4 ring collectives: the Hopper kernels and their plain
PyTorch versions.

Port of ``repro.kernels.ring``: the three dense kernels (CUDA source
``csrc/ring.cu``) and the three of the compressed wire formats
(``csrc/ring_wire.cu``); each source states its kernels' design and bound.
The hop and the reduce-scatter share one kernel, a left fold of rows in
registers: the hop folds ``recv`` and one chunk, the reduce-scatter every
member's partial of a strip in the ring's order, in one launch.

:func:`ring_hop_accum`       one hop of the distributed ring: ``recv +
                             chunks[c]`` (the process mesh's combine after
                             each neighbour receive); its member-batched
                             form :func:`ring_hop_accum_members` adds each
                             member's own chunk to its message (the gossip
                             pair add of a local mesh).
:func:`ring_reduce_scatter`  the stacked single-device ring over a
                             ``(G, N)`` buffer, member p's partial in row p:
                             row p of the ``(G, N / G)`` result is the fully
                             reduced chunk p (the local mesh's part-reduce).
:func:`ring_all_gather`      ``(G, n)`` strips to ``(G, G * n)``, every row
                             the strips in owner order (its part-broadcast).
:func:`int8_quantize`        a 1-D f32 message to ``(q int8, scale (1,))``,
                             the first send of the int8 ring.
:func:`ring_hop_int8`        one int8 hop: ``q * s + chunks[c]`` in f32,
                             re-quantized on a fresh max-abs scale.
:func:`ring_hop_topk`        one top-k hop: the ``(vals, idx)`` message
                             scattered dense, plus ``chunks[c]``.

The wire kernels keep the reference's per-member signatures (the process
mesh calls them once per hop) and have a member-batched form for the local
mesh, which runs one hop of all G members of a ``(G, N)`` stack in one call
(:func:`int8_quantize_members`, :func:`ring_hop_int8_members`,
:func:`ring_hop_topk_members`): at step s member m adds its chunk
``(m - 2 - s) % G`` to the message of row ``(m - 1) % G``, and row m of the
result is what it sends on.

Each wrapper computes its plain version on CPU tensors (that is how the CPU
tests run it) and on CUDA tensors launches its kernel or raises; it never
falls back.  The ``*_plain`` functions repeat the kernels' arithmetic in the
same order and dtype, so a kernel agrees with its plain version bitwise.
Additions happen in the input dtype, as in the reference: the ring's hop
adds are the wire arithmetic.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels.build import launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset, per wrapper (the plain versions are
# not counted): one a call, G = 1 (no kernel) aside; the int8 kernel is one
# cooperative launch of two passes, the top-k one two launches a range of 8
# Mi elements, and each call counts one
launches = {"ring_hop_accum": 0, "ring_reduce_scatter": 0,
            "ring_all_gather": 0, "int8_quantize": 0, "ring_hop_int8": 0,
            "ring_hop_topk": 0}


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


def _check_rows(name: str, x: torch.Tensor, dim: int = 2,
                dtypes=tuple(_DTYPES)) -> None:
    if x.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {x.dtype}")
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
    _check_chunk_index(c, G, chunks.device)
    if chunks.device.type == "cpu":
        return ring_hop_accum_plain(chunks, recv, c)
    out = torch.empty_like(recv)
    tensor_c = isinstance(c, torch.Tensor)
    # the fold of two rows: recv, then chunk c (member stride 0: one member)
    _launch_fold(recv, chunks, 0, chunks.stride(0), out,
                 c.data_ptr() if tensor_c else None, 0 if tensor_c else int(c),
                 G, 1, 1, n)
    launches["ring_hop_accum"] += 1
    return out


def ring_hop_accum_members_plain(stacked: torch.Tensor,
                                 recv: torch.Tensor) -> torch.Tensor:
    """Row p: ``recv[p] + stacked[p, chunk p]`` in the input dtype."""
    return recv + member_chunks(stacked, 0)


def ring_hop_accum_members(stacked: torch.Tensor,
                           recv: torch.Tensor) -> torch.Tensor:
    """One hop of all G members of a local mesh in one launch of the fold:
    member p adds its own chunk p of ``stacked`` (G, N) (row p, a member
    stride of 0 included) to ``recv[p]``, the message it received; row p of
    the ``(G, N // G)`` result is ``recv[p] + stacked[p, chunk p]``, bitwise
    :func:`ring_hop_accum` of each member.  The gossip exchange's pair add
    (``comm.backends.gossip``)."""
    _check_rows("stacked", stacked)
    _check_rows("recv", recv)
    G, N = stacked.shape
    if G < 1 or N % G or N == 0:
        raise ValueError(f"buffer size {N} not divisible by group {G}")
    n = N // G
    if recv.dtype != stacked.dtype or recv.device != stacked.device:
        raise ValueError(f"recv ({recv.dtype}, {recv.device}) must match "
                         f"stacked ({stacked.dtype}, {stacked.device})")
    if tuple(recv.shape) != (G, n) or recv.stride(0) != n:
        raise ValueError(f"recv must be ({G}, {n}) with contiguous rows, "
                         f"got {tuple(recv.shape)} strides {recv.stride()}")
    if stacked.device.type == "cpu":
        return ring_hop_accum_members_plain(stacked, recv)
    out = torch.empty_like(recv)
    # the fold of two rows a strip: recv[p], then x[p, p], reached as chunk
    # p at a chunk stride of one member row plus one chunk (member stride 0)
    _launch_fold(recv, stacked, 0, stacked.stride(0) + n, out, None, 0, G, 1,
                 G, n)
    launches["ring_hop_accum"] += 1
    return out


def _check_chunk_index(c, G: int, device) -> None:
    if isinstance(c, torch.Tensor):
        if c.numel() != 1 or c.dtype != torch.int32 or c.device != device:
            raise ValueError(f"c must be one int32 on {device}, got "
                             f"{c.dtype} {tuple(c.shape)} on {c.device}")
    elif not 0 <= int(c) < G:
        raise ValueError(f"chunk index {c} outside [0, {G})")


def ring_reduce_scatter(stacked: torch.Tensor) -> torch.Tensor:
    """Reduce-scatter a stacked ``(G, N)`` buffer of per-member partials:
    row p of the ``(G, N // G)`` result is the fully reduced chunk p,
    member p's strip under the §3.4 owner convention.  ``N % G == 0``.  The
    member stride may be anything, 0 included (one buffer viewed G times,
    which the kernel reads once).  One launch: strip p is the left fold
    ``x[p+1, p] + x[p+2, p] + ... + x[p, p]`` (members mod G), the order in
    which the ring's G - 1 hops add it, so the result is bitwise
    :func:`ring_reduce_scatter_plain`; no mailbox is allocated."""
    _check_rows("stacked", stacked)
    G, N = stacked.shape
    if G < 1 or N % G:
        raise ValueError(f"buffer size {N} not divisible by group {G}")
    if G == 1:
        return stacked.reshape(1, N)
    if stacked.device.type == "cpu":
        return ring_reduce_scatter_plain(stacked)
    n = N // G
    out = stacked.new_empty(G, n)
    _launch_fold(None, stacked, stacked.stride(0), n, out, None, 0, G, G, G, n)
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
    launch(_lib().ring_all_gather, out.device, strips.data_ptr(),
           strips.stride(0) * es, out.data_ptr(), G, n * es)
    launches["ring_all_gather"] += 1
    return out


def _launch_fold(a, x, x_ms, x_cs, out, c_ptr, c_shift, G, R, P, n) -> None:
    """``csrc/ring.cu``'s fold into ``out`` (P, n): strip p is row p of
    ``a`` (P, n) (row 1 when ``a`` is None) plus rows 1..R, row k at ``x +
    ((p + k) % G) * x_ms + c * x_cs`` with ``c = (p + c_shift + *c_ptr) %
    G``."""
    launch(_lib().ring_fold, out.device, _DTYPES[out.dtype], _ptr(a),
           x.data_ptr(), x_ms, x_cs, out.data_ptr(), c_ptr, c_shift, G, R, P,
           n)


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("ring")
    if lib.ring_fold.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ring_fold.argtypes = [i, p, p, ll, ll, p, p, i, i, i, i, ll, p]
        lib.ring_fold.restype = ctypes.c_int
        lib.ring_all_gather.argtypes = [p, ll, p, i, ll, p]
        lib.ring_all_gather.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# the compressed wire formats (``CommConfig.wire_format``)
# ---------------------------------------------------------------------------
_F32, _I8, _I32 = (torch.float32,), (torch.int8,), (torch.int32,)


def member_chunks(stacked: torch.Tensor, shift: int) -> torch.Tensor:
    """Row m: member m's chunk ``(m + shift) % G`` of a ``(G, N)`` stack."""
    G = stacked.shape[0]
    m = torch.arange(G, device=stacked.device)
    return stacked.view(G, G, -1)[m, (m + shift) % G]


def _one_chunk(chunks: torch.Tensor, c) -> torch.Tensor:
    return chunks.index_select(0, _chunk_index(c, chunks.device))


def _int8_plain(x, q=None, scale=None):
    """Each row of ``x`` (M, n) f32, plus the message ``q`` (M, n) int8 at
    ``scale`` (M,) dequantized, re-quantized on the row's max-abs scale:
    the kernel's arithmetic, product and sum rounded apart."""
    acc = x if q is None else q.float() * scale[:, None] + x
    s = kref.int8_scale_ref(acc.abs().amax(-1))
    return torch.round(kref.ieee_div(acc, s[:, None])).to(torch.int8), s


def _topk_plain(x, vals, idx):
    """Each row of ``x`` (M, n) f32 plus its message ``(vals, idx)`` (M, k)
    scattered dense, ``(0 + x) + v`` at the (unique) indices: the kernel's
    arithmetic, and bitwise the reference's ``(0 + v) + x``.  A gather, an
    add and a scatter, never ``scatter_add_``, whose CUDA atomics flush
    subnormals to zero."""
    out = torch.zeros_like(x) + x
    i = idx.long()
    return out.scatter_(1, i, out.gather(1, i) + vals)


def int8_quantize_plain(x: torch.Tensor):
    q, s = _int8_plain(x.float()[None])
    return q[0], s


def ring_hop_int8_plain(chunks, q, scale, c):
    q2, s2 = _int8_plain(_one_chunk(chunks, c).float(), q[None],
                         scale.reshape(1))
    return q2[0], s2


def ring_hop_topk_plain(chunks, vals, idx, c):
    return _topk_plain(_one_chunk(chunks, c).float(), vals.float()[None],
                       idx[None])[0]


def int8_quantize_members_plain(stacked: torch.Tensor):
    return _int8_plain(member_chunks(stacked, -1))


def ring_hop_int8_members_plain(stacked, q, scale, step: int):
    return _int8_plain(member_chunks(stacked, -2 - step), q.roll(1, 0),
                       scale.roll(1, 0))


def ring_hop_topk_members_plain(stacked, vals, idx, step: int):
    return _topk_plain(member_chunks(stacked, -2 - step), vals.roll(1, 0),
                       idx.roll(1, 0))


def _check_same_device(ref: torch.Tensor, **named) -> None:
    for name, t in named.items():
        if t.device != ref.device:
            raise ValueError(f"{name} lies on {t.device}, the chunks on "
                             f"{ref.device}")


def _check_stack(stacked: torch.Tensor):
    """(G, n) of a ``(G, N)`` f32 stack of member buffers."""
    _check_rows("stacked", stacked, dtypes=_F32)
    G, N = stacked.shape
    if G < 2 or N % G or N == 0:
        raise ValueError(f"a ({G}, {N}) stack is not G >= 2 non-empty "
                         f"member buffers of G chunks each")
    return G, N // G


def _check_message(name, t, shape, dtypes) -> None:
    _check_rows(name, t, dim=len(shape), dtypes=dtypes)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if len(shape) == 2 and t.stride(0) != shape[1]:
        raise ValueError(f"{name}'s rows must be contiguous, got strides "
                         f"{t.stride()}")


def _check_sparse(vals, idx, rows) -> int:
    """k of a top-k message: ``vals`` f32 and ``idx`` int32 of shape
    ``rows + (k,)``."""
    k = vals.shape[-1] if vals.dim() else 0
    _check_message("vals", vals, rows + (k,), _F32)
    _check_message("idx", idx, rows + (k,), _I32)
    return k


def int8_quantize(x: torch.Tensor):
    """Quantize a 1-D f32 message to ``(q int8 (n,), scale f32 (1,))`` with
    a symmetric per-message max-abs scale: ``s = max|x| / 127`` (1 for an
    all-zero message), ``q = round(x / s)``, half to even.  The first send
    of the int8 ring; every later hop re-quantizes in
    :func:`ring_hop_int8`."""
    _check_rows("x", x, dim=1, dtypes=_F32)
    n = x.shape[0]
    if n == 0:
        raise ValueError("x must not be empty")
    if x.device.type == "cpu":
        return int8_quantize_plain(x)
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    s = torch.empty(1, dtype=torch.float32, device=x.device)
    _launch_int8(x, 0, 0, None, None, 0, 0, q, s, 0, None, 0, 1, 1, n)
    launches["int8_quantize"] += 1
    return q, s


def ring_hop_int8(chunks: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                  c: Union[int, torch.Tensor]):
    """One int8 ring hop: dequantize the received message ``(q (n,) int8,
    scale (1,) f32)``, add this member's chunk ``c`` of ``chunks`` (G, n) f32
    in f32 and re-quantize on a fresh max-abs scale.  Returns the next wire
    message ``(q', scale')``.  ``c`` as in :func:`ring_hop_accum`."""
    _check_rows("chunks", chunks, dtypes=_F32)
    G, n = chunks.shape
    if n == 0:
        raise ValueError("chunks must not be empty")
    _check_message("q", q, (n,), _I8)
    _check_message("scale", scale, (1,), _F32)
    _check_same_device(chunks, q=q, scale=scale)
    _check_chunk_index(c, G, chunks.device)
    if chunks.device.type == "cpu":
        return ring_hop_int8_plain(chunks, q, scale, c)
    q2, s2 = torch.empty_like(q), torch.empty_like(scale)
    tensor_c = isinstance(c, torch.Tensor)
    _launch_int8(chunks, 0, chunks.stride(0), q, scale, 0, 0, q2, s2, 0,
                 c if tensor_c else None, 0 if tensor_c else int(c), G, 1, n)
    launches["ring_hop_int8"] += 1
    return q2, s2


def ring_hop_topk(chunks: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                  c: Union[int, torch.Tensor]) -> torch.Tensor:
    """One top-k ring hop: scatter-add the received sparse message ``(vals
    (k,) f32, idx (k,) int32)`` into a dense f32 buffer and add this
    member's chunk ``c`` of ``chunks`` (G, n) f32.  Returns the dense
    ``(n,)`` sum; the backend re-selects before it forwards.  The indices
    must be unique (a top-k selection's are): the kernel adds each entry
    once, one rounding per entry, with a plain load and store, so a
    repeated index keeps one of its adds (the reference sums them).  An
    index outside ``[0, n)`` is dropped."""
    _check_rows("chunks", chunks, dtypes=_F32)
    G, n = chunks.shape
    if n == 0:
        raise ValueError("chunks must not be empty")
    k = _check_sparse(vals, idx, ())
    _check_same_device(chunks, vals=vals, idx=idx)
    _check_chunk_index(c, G, chunks.device)
    if chunks.device.type == "cpu":
        return ring_hop_topk_plain(chunks, vals, idx, c)
    out = chunks.new_empty(n)
    tensor_c = isinstance(c, torch.Tensor)
    _launch_topk(chunks, 0, chunks.stride(0), vals, idx, 0, 0, k, out, 0,
                 c if tensor_c else None, 0 if tensor_c else int(c), G, 1, n)
    launches["ring_hop_topk"] += 1
    return out


def int8_quantize_members(stacked: torch.Tensor):
    """The first send of the int8 ring for all G members of a ``(G, N)``
    f32 stack (any member stride, 0 included): row m of ``(q (G, n) int8,
    scale (G,) f32)`` is member m's chunk ``(m - 1) % G`` quantized.  On
    the card G may not exceed the blocks the kernel's cooperative grid
    holds at once (528 to 1056 on an H100, by kernel instance): past that
    the launch is refused and this raises; so for
    :func:`ring_hop_int8_members`."""
    G, n = _check_stack(stacked)
    if stacked.device.type == "cpu":
        return int8_quantize_members_plain(stacked)
    q = torch.empty(G, n, dtype=torch.int8, device=stacked.device)
    s = torch.empty(G, dtype=torch.float32, device=stacked.device)
    _launch_int8(stacked, stacked.stride(0), n, None, None, 0, 0, q, s, n,
                 None, -1, G, G, n)
    launches["int8_quantize"] += 1
    return q, s


def ring_hop_int8_members(stacked: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor, step: int):
    """Step ``step`` of the int8 ring for all G members at once: member m
    dequantizes row ``(m - 1) % G`` of ``(q (G, n), scale (G,))``, adds its
    chunk ``(m - 2 - step) % G`` and re-quantizes into row m of the
    result."""
    G, n = _check_stack(stacked)
    _check_message("q", q, (G, n), _I8)
    _check_message("scale", scale, (G,), _F32)
    _check_same_device(stacked, q=q, scale=scale)
    if stacked.device.type == "cpu":
        return ring_hop_int8_members_plain(stacked, q, scale, step)
    q2, s2 = torch.empty_like(q), torch.empty_like(scale)
    _launch_int8(stacked, stacked.stride(0), n, q, scale, n, -1, q2, s2, n,
                 None, -2 - step, G, G, n)
    launches["ring_hop_int8"] += 1
    return q2, s2


def ring_hop_topk_members(stacked: torch.Tensor, vals: torch.Tensor,
                          idx: torch.Tensor, step: int) -> torch.Tensor:
    """Step ``step`` of the top-k ring for all G members at once: row m of
    the ``(G, n)`` result is row ``(m - 1) % G`` of ``(vals, idx)`` (G, k)
    scattered dense plus member m's chunk ``(m - 2 - step) % G``.  Indices
    as in :func:`ring_hop_topk`."""
    G, n = _check_stack(stacked)
    k = _check_sparse(vals, idx, (G,))
    _check_same_device(stacked, vals=vals, idx=idx)
    if stacked.device.type == "cpu":
        return ring_hop_topk_members_plain(stacked, vals, idx, step)
    out = stacked.new_empty(G, n)
    _launch_topk(stacked, stacked.stride(0), n, vals, idx, k, -1, k, out, n,
                 None, -2 - step, G, G, n)
    launches["ring_hop_topk"] += 1
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_int8(x, x_ms, x_cs, q, qs, q_ms, q_shift, out, s_out, o_ms,
                 c_dev, c_shift, G, M, n) -> None:
    # the kernel's block slots: every call writes each slot it reads, so a
    # fresh allocation on the current stream needs no zeroing, and two
    # calls that may overlap (other streams, graph replays) never share one
    ws = torch.empty(_int8_slots(out.device.index), dtype=torch.int32,
                     device=out.device)
    launch(_wire_lib().ring_wire_int8, out.device, x.data_ptr(), x_ms, x_cs,
           _ptr(q), _ptr(qs), q_ms, q_shift, out.data_ptr(), s_out.data_ptr(),
           o_ms, ws.data_ptr(), ws.numel(), _ptr(c_dev), c_shift, G, M, n)


@functools.cache
def _int8_slots(index: int) -> int:
    """The most blocks the int8 kernel's grid holds on device ``index``."""
    with torch.cuda.device(index):
        slots = _wire_lib().ring_wire_int8_slots()
    if slots < 1:
        raise RuntimeError(f"ring_wire_int8_slots failed on cuda:{index}")
    return slots


def _launch_topk(x, x_ms, x_cs, vals, idx, v_ms, v_shift, k, out, o_ms,
                 c_dev, c_shift, G, M, n) -> None:
    launch(_wire_lib().ring_wire_topk, out.device, x.data_ptr(), x_ms, x_cs,
           vals.data_ptr(), idx.data_ptr(), v_ms, v_shift, k, out.data_ptr(),
           o_ms, _ptr(c_dev), c_shift, G, M, n)


@functools.cache
def _wire_lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("ring_wire")
    if lib.ring_wire_int8.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ring_wire_int8.argtypes = [p, ll, ll, p, p, ll, i, p, p, ll, p,
                                       ll, p, i, i, i, ll, p]
        lib.ring_wire_int8.restype = ctypes.c_int
        lib.ring_wire_int8_slots.argtypes = []
        lib.ring_wire_int8_slots.restype = ll
        lib.ring_wire_topk.argtypes = [p, ll, ll, p, p, ll, i, ll, p, ll, p,
                                       i, i, i, ll, p]
        lib.ring_wire_topk.restype = ctypes.c_int
    return lib
