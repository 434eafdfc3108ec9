"""A CPU model of the int8 wire kernel's work split (``csrc/ring_wire.cu``'s
``int8_wire_kernel``: one cooperative launch, pass 1 forward, a grid
barrier, pass 2 backward), against the port's plain versions and the JAX
package's kernels.

The model repeats the kernel's index arithmetic in numpy and torch.  It
reads ``kThreads``, ``kLoads`` and both passes' loops over tiles from
``csrc/ring_wire.cu`` itself, and checks that the other lines it repeats
stand there as modelled; the gpu-marked card tests are what run the
kernel.  It covers the grid the C entry sizes (the blocks the card holds
at once, spread over M members, one at least; more members than that is
an error), each block's tiles (``b, b + B, ...`` forward in pass 1, the same backward in pass 2),
each thread's ``kLoads`` units a tile, the vector path's ragged end (``n %
4`` elements on block 0) and the scalar path, the member offsets (chunk
``(m + c_shift + c_dev) mod G`` at ``m * x_ms + c * x_cs``, message row
``(m + msg_shift) mod M``).  It checks that every element of every member
is read exactly once in each pass and written once, that the folded
per-block maxima equal ``acc.abs().amax(-1)`` bitwise, and that the
model's ``(q, s)`` equal ``int8_quantize_members_plain`` /
``ring_hop_int8_members_plain`` bitwise.

Those plain versions are then held to the JAX package's ``int8_quantize``
and ``ring_hop_int8`` in interpret mode at the tolerance of
``tests/test_torch_ring_wire.py`` (the scale within one f32 ulp, or the
FMA's half ulp over 127 plus two for a hop; ``q`` within +-1, bitwise
where the scale agrees).  Subnormal rows are held to the plain versions
only: XLA on the CPU flushes subnormals to zero (a subnormal message gets
the reference's scale 1 and ``q = 0``), the card does not.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ring as jring  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ring as kring  # noqa: E402

SRC = (Path(kring.__file__).parent / "csrc" / "ring_wire.cu").read_text()


def _const(name):
    """The value of ``constexpr int <name> = <value>;`` in the kernel."""
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m, f"no constexpr int {name} in ring_wire.cu"
    return int(m.group(1))


THREADS, LOADS = _const("kThreads"), _const("kLoads")
TILE = THREADS * LOADS                # kTile: units a tile
# the co-resident blocks the model's card holds: 1, 7, and 132 SMs times
# 4 or 8 blocks (H100: 8 of the smallest instance, 4 of the vector hop's)
HELD = [1, 7, 132 * 4, 132 * 8]
# VGG-A's 14 fusion buckets at G = 4: each member's chunk
VGG_NS = [240352, 294912, 128, 589824, 128, 589824, 128, 589824, 1024,
          25690112, 1024, 4194304, 250, 1024000]
NS = sorted({1, 3, 250, 2 ** 20 + 3, *VGG_NS})


class TooLarge(Exception):
    """The entry's cudaErrorCooperativeLaunchTooLarge."""


def units_of(n, vec):
    return n // 4 if vec else n


def blocks_a_member(n, M, vec, held):
    """``ring_wire_int8``'s grid.x: the member's tiles, at most its share
    of the blocks held at once, at least 1; refused past ``held``."""
    tiles = -(-units_of(n, vec) // TILE)
    per = max(1, min(held // M, tiles))
    if per * M > held:
        raise TooLarge
    return per


def _tile_loop(fn):
    """The loop over tiles ``t`` in the kernel's device function ``fn``, as
    a Python function of ``(b, B, tiles)`` that lists the tiles it visits:
    the ``for (long long t = ...; ...; t +/-= B)`` header and the ``if``
    that guards it, read from ``csrc/ring_wire.cu`` (``blockIdx.x`` is b,
    ``gridDim.x`` B, ``v.tiles`` tiles; every operand is non-negative where
    it divides, so C's ``/`` is ``//``)."""
    start = SRC.index(f" {fn}(const WireArgs& p)")
    body = SRC[start:SRC.index("\n}\n", start)]
    m = re.search(r"(?:if \(([^)]*)\) \{\s*)?"
                  r"for \(long long t = ([^;]+); ([^;]+); t ([+-])= B\)", body)
    assert m, f"no loop over tiles in {fn}"

    def py(expr):
        return (expr.replace("blockIdx.x", "b").replace("v.tiles", "tiles")
                .replace("/", "//"))
    guard, init, cond, sign = m.groups()
    env = {}
    exec(f"def visits(b, B, tiles):\n"
         f"    if not ({py(guard) if guard else 'True'}):\n"
         f"        return []\n"
         f"    out, t = [], {py(init)}\n"
         f"    while {py(cond)}:\n"
         f"        out.append(t)\n"
         f"        t {sign}= B\n"
         f"    return out\n", env)
    return env["visits"]


pass1_tiles = _tile_loop("int8_pass1")   # forward: b, b + B, ...
pass2_tiles = _tile_loop("int8_pass2")   # the same tiles backward


def tile_units(ts, units):
    """Unit ``t * TILE + x + u * THREADS`` of thread x's load u for each
    tile t of ``ts``, where it is below ``units`` (the kernel's guard), in
    load order."""
    x = np.arange(THREADS)[None, None, :]
    u = np.arange(LOADS)[None, :, None]
    i = (np.asarray(ts, np.int64)[:, None, None] * TILE + x + u * THREADS)
    i = i.reshape(-1)
    return i[i < units]


def tail_elements(b, n, vec):
    """The vector path's ragged end: block 0's threads x < n % 4."""
    if not vec or b != 0:
        return np.zeros(0, np.int64)
    return 4 * (n // 4) + np.arange(THREADS)[: n - 4 * (n // 4)]


def elements(units_idx, vec):
    """The elements a unit covers: 4 floats of a vector, or one."""
    if not vec:
        return units_idx
    return (4 * units_idx[:, None] + np.arange(4)[None, :]).reshape(-1)


def member_rows(M, G, c_shift, msg_shift, c_dev=0):
    """(chunk, message row) of each member, as ``member()`` computes them:
    C's ``%`` keeps the sign, ``wrap`` adds the modulus back."""
    def wrap(i, m):
        r = int(np.fmod(i, m))
        return r + m if r < 0 else r
    return [(wrap(m + c_shift + c_dev, G), wrap(m + msg_shift, M))
            for m in range(M)]


def _flat(st):
    """The storage of a stack from its first element on, as the kernel's
    pointer sees it."""
    size = st.untyped_storage().nbytes() // st.element_size()
    return torch.as_strided(st, (size - st.storage_offset(),), (1,))


def kernel_model(x_flat, x_ms, x_cs, G, M, n, c_shift, held, vec,
                 msg=None, msg_shift=0):
    """What the kernel computes, block by block: returns ``(q (M, n) int8,
    s (M,), slots (M, B) int32 bits, counts (3, M, n))``, the counts of
    each element's reads in pass 1 and pass 2 and its writes.  ``x_flat``
    is the chunks' storage; ``msg`` a ``(q (M, n) int8, s (M,))``
    message."""
    B = blocks_a_member(n, M, vec, held)
    units = units_of(n, vec)
    tiles = -(-units // TILE)
    q_out = torch.zeros(M, n, dtype=torch.int8)
    s_out = torch.zeros(M)
    slots = torch.zeros(M, B, dtype=torch.int32)
    counts = np.zeros((3, M, n), np.int64)
    for m, (c, r) in enumerate(member_rows(M, G, c_shift, msg_shift)):
        x = x_flat[m * x_ms + c * x_cs:][:n]
        acc = x if msg is None else msg[0][r].float() * msg[1][r] + x
        bits = acc.abs().view(torch.int32)
        read1, read2 = [], []
        for b in range(B):          # pass 1: each block's max into its slot
            e = np.concatenate([elements(tile_units(pass1_tiles(b, B, tiles),
                                                    units), vec),
                                tail_elements(b, n, vec)])
            read1.append(e)
            slots[m, b] = bits[torch.from_numpy(e)].max() if e.size else 0
        # the grid barrier; every block folds the member's slots
        s = ref.int8_scale_ref(slots[m].max().view(torch.float32).reshape(1))
        for b in range(B):          # pass 2: q' of what the block reads
            e = np.concatenate([elements(tile_units(pass2_tiles(b, B, tiles),
                                                    units), vec),
                                tail_elements(b, n, vec)])
            read2.append(e)
            idx = torch.from_numpy(e)
            q_out[m, idx] = torch.round(ref.ieee_div(acc[idx], s)).to(
                torch.int8)
        s_out[m] = s[0]
        counts[0, m] = np.bincount(np.concatenate(read1), minlength=n)
        counts[1, m] = counts[2, m] = np.bincount(np.concatenate(read2),
                                                  minlength=n)
    return q_out, s_out, slots, counts


def _rows(G, N, kind, seed):
    """A (G, N) stack of member buffers: random, all zero, -0.0,
    subnormal, or random with one all-zero member."""
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=(G, N))
                         .astype(np.float32))
    if kind == "zeros":
        return torch.zeros(G, N)
    if kind == "negzero":
        return -torch.zeros(G, N)
    if kind == "subnormal":
        return x * 2.0 ** -130
    if kind == "one_zero_row":
        x[G // 2] = 0
    return x


# ---------------------------------------------------------------------------
# the work split, tile by tile (every VGG-A chunk size at every grid)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vec", [True, False], ids=["vec", "scalar"])
@pytest.mark.parametrize("n", NS)
def test_each_pass_covers_every_unit_once(n, vec):
    """Pass 1's and pass 2's tiles of all blocks are each a permutation of
    the member's tiles, pass 2 each block's in reverse; a tile's loads
    cover its units once; the units and the vector tail cover [0, n) once.
    Grids of 1, 7 and 132 x k blocks; M of 1-8 (more than the grid holds
    is refused, as the entry refuses it)."""
    units = units_of(n, vec)
    tiles = -(-units // TILE)
    assert sorted(tile_units([0], TILE).tolist()) == list(range(TILE))
    assert tile_units([tiles - 1], units).tolist() == sorted(
        tile_units([tiles - 1], units).tolist())
    assert sorted(tile_units([tiles - 1], units).tolist()) == list(
        range((tiles - 1) * TILE, units))
    # units, then the tail, tile [0, n): checked at the ends, the rest
    # follows (4i + lane is one to one)
    k = min(units, 3)
    assert elements(np.arange(k), vec).tolist() == list(range(k * (4 if vec else 1)))
    assert tail_elements(0, n, vec).tolist() == (
        list(range(4 * units, n)) if vec else [])
    assert tail_elements(1, n, vec).size == 0
    for held in HELD:
        for M in range(1, 9):
            if M > held:
                with pytest.raises(TooLarge):
                    blocks_a_member(n, M, vec, held)
                continue
            B = blocks_a_member(n, M, vec, held)
            assert 1 <= B and B * M <= held and (B <= tiles or B == 1)
            fwd = [pass1_tiles(b, B, tiles) for b in range(B)]
            bwd = [pass2_tiles(b, B, tiles) for b in range(B)]
            assert all(f[::-1] == r for f, r in zip(fwd, bwd))
            assert sorted(sum(fwd, [])) == list(range(tiles))


# ---------------------------------------------------------------------------
# member offsets: stride 0, the wrappers' shifts and the wraps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("G", [2, 3, 4, 8])
def test_member_offsets_and_message_rows(G):
    """The kernel's chunk and message row of member m, from the wrappers'
    arguments, pick ``member_chunks`` and ``roll(1, 0)`` of the plain
    versions, for a contiguous and a stride-0 stack at every ring step;
    one member's call picks chunk c (a host index, or c_dev on the card
    at c_shift 0), and c_dev past G wraps."""
    n = 5
    dense = torch.arange(G * G * n, dtype=torch.float32).view(G, G * n)
    for st in (dense, dense[1].expand(G, G * n)):
        flat = _flat(st)
        for shift in [-1] + [-2 - step for step in range(G - 1)]:
            for m, (c, r) in enumerate(member_rows(G, G, shift, -1)):
                got = flat[m * st.stride(0) + c * n:][:n]
                assert torch.equal(got, kring.member_chunks(st, shift)[m])
                assert r == (m - 1) % G    # q.roll(1, 0)'s row m
    chunks = torch.arange(G * n, dtype=torch.float32).view(G, n)
    for c in range(G):
        for c_shift, c_dev in ((c, 0), (0, c), (0, c + 3 * G), (c - G, 0)):
            (got, r), = member_rows(1, G, c_shift, 0, c_dev)
            assert got == c and r == 0


# ---------------------------------------------------------------------------
# the model's numbers: folded maxima, (q, s) bitwise the plain versions
# ---------------------------------------------------------------------------
CASES = [  # (n, M, held, kind)
    (1, 1, 1, "random"), (3, 2, 7, "random"), (3, 4, 7, "zeros"),
    (250, 4, 7, "random"), (250, 8, 132 * 8, "subnormal"),
    (250, 3, 132 * 4, "negzero"), (1024, 4, 132 * 4, "one_zero_row"),
    (128, 4, 132 * 8, "random"), (2 ** 20 + 3, 1, 7, "random"),
    (2 ** 20 + 3, 8, 132 * 8, "random"), (2 ** 20 + 3, 2, 132 * 4, "subnormal"),
    (240352, 4, 132 * 4, "random"), (294912, 4, 132 * 8, "one_zero_row"),
    (589824, 4, 132 * 4, "random"), (1024000, 4, 132 * 4, "random"),
]


@pytest.mark.parametrize("n,M,held,kind", CASES)
def test_model_matches_the_plain_versions_bitwise(n, M, held, kind):
    """Member-batched quantize and one hop through the model, over a
    contiguous stack (the vector path where the rows start 16-byte
    aligned) and a stride-0 stack, and over an unaligned stack (the scalar
    path): each element read once a pass and written once, the folded
    maxima equal to ``acc.abs().amax(-1)``, ``(q, s)`` bitwise the plain
    versions'."""
    G = max(M, 2)
    stacks = {"contiguous": _rows(G, G * n, kind, seed=n + M)}
    if M == G:
        stacks["stride0"] = _rows(1, G * n, kind, seed=n).expand(G, G * n)
    for name, st in stacks.items():
        flat = _flat(st)
        for vec in (True, False):
            # M < G: members 0..M-1 of the stack (the kernel takes any M)
            q, s, slots, counts = kernel_model(flat, st.stride(0), n, G, M, n,
                                               -1, held, vec)
            assert (counts == 1).all(), (name, vec)
            acc = kring.member_chunks(st, -1)[:M]
            assert torch.equal(slots.max(1).values.view(torch.float32),
                               acc.abs().amax(-1))
            if M < G:
                want = [kring.int8_quantize_plain(a) for a in acc]
                assert torch.equal(q, torch.stack([w[0] for w in want]))
                assert torch.equal(s, torch.cat([w[1] for w in want]))
                continue
            want = kring.int8_quantize_members_plain(st)
            assert torch.equal(q, want[0]) and torch.equal(s, want[1])
            q2, s2, slots, counts = kernel_model(
                flat, st.stride(0), n, G, M, n, -2, held, vec, msg=(q, s),
                msg_shift=-1)
            assert (counts == 1).all(), (name, vec)
            acc = kring.member_chunks(st, -2) + q.roll(1, 0).float() \
                * s.roll(1, 0)[:, None]
            assert torch.equal(slots.max(1).values.view(torch.float32),
                               acc.abs().amax(-1))
            want = kring.ring_hop_int8_members_plain(st, q, s, 0)
            assert torch.equal(q2, want[0]) and torch.equal(s2, want[1])


# the kernel's lines whose arithmetic the model repeats, with how often
# each stands in csrc/ring_wire.cu: a change to one fails here, and the
# model above is to follow it
MIRRORED = [
    ("constexpr long long kTile = static_cast<long long>(kThreads) * kLoads;", 1),
    ("units = kVec ? p.n / 4 : p.n;", 1),
    ("tiles = (units + kTile - 1) / kTile;", 2),
    ("tail = kVec && blockIdx.x == 0 ? p.n - 4 * units : 0;", 1),
    ("const long long base = t * kTile + threadIdx.x;", 2),
    ("if (base + u * kThreads < v.units)", 4),
    ("if (threadIdx.x < v.tail)", 2),
    ("p.slots[blockIdx.y * B + blockIdx.x] = best;", 1),
    ("for (long long b = threadIdx.x; b < B; b += kThreads)", 1),
    ("long long per = held / M < tiles ? held / M : tiles;", 1),
    ("per = per > 0 ? per : 1;", 1),
    ("if (per * M > held) return static_cast<int>("
     "cudaErrorCooperativeLaunchTooLarge);", 1),
]


@pytest.mark.parametrize("line,count", MIRRORED,
                         ids=[str(i) for i in range(len(MIRRORED))])
def test_the_model_mirrors_the_kernel_source(line, count):
    """The index arithmetic the model repeats by hand stands in the kernel
    as modelled (its constants and tile loops the model reads from it)."""
    assert SRC.count(line) == count, line


def test_more_members_than_the_grid_holds_is_refused():
    for held in (1, 7):
        with pytest.raises(TooLarge):
            kernel_model(torch.zeros(8 * 8), 8, 1, 8, held + 1, 1, -1, held,
                         True)


# ---------------------------------------------------------------------------
# the plain versions against the JAX package's kernels in interpret mode
# ---------------------------------------------------------------------------
def _assert_within_jit(got, want, s_in=None):
    """``tests/test_torch_ring_wire.py``'s tolerance against the reference
    under jit (a rounded reciprocal of 127; a hop's contracted FMA)."""
    q, s = got[0].numpy().astype(np.int32), got[1].numpy()
    wq, ws = np.asarray(want[0]).astype(np.int32), np.asarray(want[1])
    ulp = float(np.spacing(np.float32(ws[0])))
    if s_in is None:
        assert abs(float(s[0]) - float(ws[0])) <= ulp
        if s[0] == ws[0]:
            np.testing.assert_array_equal(q, wq)
    else:
        fma = 0.5 * float(np.spacing(np.float32(127 * float(s_in)))) / 127
        assert abs(float(s[0]) - float(ws[0])) <= fma + 2 * ulp
    assert np.abs(q - wq).max() <= 1


@pytest.mark.parametrize("n,kind", [
    (n, kind) for n in (1, 3, 250)
    for kind in ("random", "zeros", "negzero", "one_zero_row")]
    + [(2 ** 20 + 3, "random")])
def test_plain_versions_match_the_reference_kernels(n, kind):
    """Each member of ``int8_quantize_members_plain`` and of one
    ``ring_hop_int8_members_plain`` step against the reference's Pallas
    ``int8_quantize`` / ``ring_hop_int8`` (interpret mode) on that
    member's chunk and message."""
    G = 4
    st = _rows(G, G * n, kind, seed=n + 1) * 10.0
    q, s = kring.int8_quantize_members_plain(st)
    q2, s2 = kring.ring_hop_int8_members_plain(st, q, s, 0)
    for m in range(G):
        x = kring.member_chunks(st, -1)[m]
        want = jring.int8_quantize(jnp.asarray(x.numpy()), interpret=True)
        _assert_within_jit((q[m], s[m:m + 1]), want)
        r = (m - 1) % G
        chunks = st[m].view(G, n)
        want = jring.ring_hop_int8(jnp.asarray(chunks.numpy()),
                                   jnp.asarray(q[r].numpy()),
                                   jnp.asarray(s[r:r + 1].numpy()),
                                   jnp.int32((m - 2) % G), interpret=True)
        _assert_within_jit((q2[m], s2[m:m + 1]), want, s_in=s[r].item())
