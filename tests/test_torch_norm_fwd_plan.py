"""The norm forwards' launch plan and index math, rehearsed on the CPU.

``csrc/int_norm.cu`` runs ``int_layernorm_fwd`` / ``int_rmsnorm_fwd`` as
one launch: ``norm_fwd_cached`` (blocks of ``gpb`` groups of ``wr`` warps,
a group per row, 2 units of 8 columns a lane kept in registers, rows
grid-strided over ``nb`` blocks) or, for any other shape, the any-shape
body (``ln_fwd_kernel`` / ``rms_fwd_kernel``: a 256-thread block per row).
The functions below are numpy models of the kernels' index math, line for
line: which rows a group takes, which columns a lane's units hold, which
shared-memory slots a warp's row sums land in and which its group reads
back, and which named barrier a group waits at.  The tests show that every
row, column and element is covered exactly once at the configs' widths (D
= 128, 576, 768, 1024, 2048), the tests' (7, 1000, 4104) and R in {0, 1,
4, 37, 256, 2048, 4096, 4608}, and hold the Python plan
(``int_norm.fwd_warps_per_row`` / ``fwd_blocks``) and the wrappers'
launch arguments against them.  One ``cuda`` test holds the register body
against the any-shape body and the plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import int_norm  # noqa: E402

WARPS, VEC, UNITS = int_norm.BWD_WARPS, int_norm.BWD_VEC, 2
WARP_COLS = int_norm.BWD_WARP_COLS
THREADS = 32 * WARPS

WIDTHS = [128, 576, 768, 1024, 2048, 7, 1000, 4104]
ROWS = [0, 1, 4, 37, 256, 2048, 4096, 4608]
#: streaming multiprocessors: an H100's, and a smaller card's
SMS = [132, 16]


def cached_rows(R, wr, gpb, nb):
    """norm_fwd_cached: the rows of every group, (nb * gpb) lists — group
    grp of block b takes rows b * gpb + grp + j * nb * gpb."""
    groups = nb * gpb
    return [np.arange(b * gpb + grp, R, groups)
            for b in range(nb) for grp in range(gpb)]


def cached_columns(D, wr):
    """norm_fwd_cached: (warp position q, unit k, lane, element e) ->
    column, for the units u = (q * UNITS + k) * 32 + lane < D / 8 that are
    loaded (and whose y is stored)."""
    q, k, lane, e = np.meshgrid(np.arange(wr), np.arange(UNITS),
                                np.arange(32), np.arange(VEC), indexing="ij")
    u = (q * UNITS + k) * 32 + lane
    return (u * VEC + e)[u < D // VEC]


def any_shape(R, D):
    """ln_fwd_kernel / rms_fwd_kernel: block b takes row b; thread t
    columns t, t + 256, ..."""
    return ([np.array([b]) for b in range(R)],
            [np.arange(t, D, THREADS) for t in range(THREADS)])


def group_sum_slots(wr, gpb):
    """The row sums' shared memory (red[parity][warp][4], flattened per
    parity): the slots warp w writes (w * 4 + i) and the slots group grp
    reads back ((grp * wr + j) * 4 + i, j < wr), and the named barrier
    (id, threads) each group waits at."""
    writes = {w: {w * 4 + i for i in range(4)} for w in range(wr * gpb)}
    reads = {g: {(g * wr + j) * 4 + i for j in range(wr) for i in range(4)}
             for g in range(gpb)}
    barriers = {g: (1 + g, wr * 32) for g in range(gpb)}
    return writes, reads, barriers


def _once(counts):
    return counts.size == 0 or (counts.min() == 1 and counts.max() == 1)


def _counts(rows, cols, R, D):
    return (np.bincount(np.concatenate(rows).astype(np.int64), minlength=R)
            if rows else np.zeros(0, np.int64),
            np.bincount(np.concatenate(cols) if isinstance(cols, list)
                        else cols, minlength=D))


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("aligned", [True, False])
def test_warps_per_row(D, aligned):
    wr = int_norm.fwd_warps_per_row(D, aligned)
    if not aligned or D % VEC or D > WARPS * WARP_COLS:
        assert wr == 0
    else:
        assert wr in (1, 2, 4, 8) and wr * WARP_COLS >= D
        assert wr == 1 or (wr // 2) * WARP_COLS < D      # the fewest warps
    assert wr == int_norm.bwd_warps_per_row(D, aligned)  # one rule for both


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("wr", [1, 2, 4, 8])
@pytest.mark.parametrize("sms", SMS)
def test_blocks(R, wr, sms):
    gpb, nb = int_norm.fwd_blocks(R, wr, sms)
    warps = int_norm.FWD_WARPS_PER_SM * sms
    assert gpb >= 1 and gpb * wr <= WARPS and WARPS // wr % gpb == 0
    assert nb >= 1
    assert nb == 1 or (nb - 1) * gpb < R             # no block without rows
    # a group for every row, or the resident warps the grid aims at
    assert nb * gpb >= R or warps <= nb * gpb * wr < warps + gpb * wr
    # the most rows a block that still fills the SMs: gpb is halved only
    # while the blocks would leave SMs idle
    assert gpb == WARPS // wr or -(-R // (2 * gpb)) < sms


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("sms", SMS)
def test_rows_and_columns_covered_once(R, D, sms):
    """Rows over the groups (or blocks), columns over one group's lanes (or
    a block's threads): each exactly once, so every element once.  Also at
    grids smaller than the plan's (the kernel grid-strides: 1 and 3
    blocks)."""
    wr = int_norm.fwd_warps_per_row(D, True)
    if wr:
        gpb, nb = int_norm.fwd_blocks(R, wr, sms)
        cols = cached_columns(D, wr)
        assert cols.max() < D
        for n in {nb, 1, 3}:
            row_counts, col_counts = _counts(cached_rows(R, wr, gpb, n),
                                             cols, R, D)
            assert len(row_counts) == R and _once(row_counts)
            assert len(col_counts) == D and _once(col_counts)
    else:
        rows, cols = any_shape(R, D)
        row_counts, col_counts = _counts(rows, cols, R, D)
        assert len(row_counts) == R and _once(row_counts)
        assert len(col_counts) == D and _once(col_counts)


@pytest.mark.parametrize("R,D,nb", [(37, 1000, None), (37, 576, None),
                                    (70, 8, 3), (5, 2048, None),
                                    (3, 4104, None), (1, 7, None),
                                    (45, 768, 2), (4, 1024, None)])
def test_elements_covered_once(R, D, nb):
    """The element count itself at small shapes (and grid-strided grids)."""
    wr = int_norm.fwd_warps_per_row(D, True)
    counts = np.zeros((R, D), np.int64)
    if wr:
        gpb, plan_nb = int_norm.fwd_blocks(R, wr, 4)
        cols = cached_columns(D, wr)
        for rows in cached_rows(R, wr, gpb, nb or plan_nb):
            counts[np.ix_(rows, cols)] += 1
    else:
        rows, cols = any_shape(R, D)
        for r in rows:
            for c in cols:
                counts[np.ix_(r, c)] += 1
    assert _once(counts)


@pytest.mark.parametrize("wr", [1, 2, 4, 8])
def test_group_sums_and_barriers(wr):
    """Each group reads back exactly the slots its own warps wrote, the
    groups' slots are disjoint and within red[parity] (8 warps x 4), and
    each group waits at its own named barrier (not 0, __syncthreads') with
    its own warps' threads."""
    for gpb in range(1, WARPS // wr + 1):
        if WARPS // wr % gpb:
            continue
        writes, reads, barriers = group_sum_slots(wr, gpb)
        for g in range(gpb):
            mine = set().union(*(writes[g * wr + q] for q in range(wr)))
            assert reads[g] == mine
        slots = [s for w in writes.values() for s in w]
        assert len(slots) == len(set(slots)) and max(slots) < WARPS * 4
        ids = [i for i, _ in barriers.values()]
        assert len(set(ids)) == gpb and 0 not in ids and max(ids) < 16
        assert all(n == wr * 32 for _, n in barriers.values())


class _FakeLib:
    """Records the forwards' launch arguments."""

    def __init__(self):
        self.calls = []

    def int_layernorm_fwd_launch(self, *args):
        self.calls.append(("ln", args))
        return 0

    def int_rmsnorm_fwd_launch(self, *args):
        self.calls.append(("rms", args))
        return 0


@pytest.mark.parametrize("R,D,xt,offset", [
    (4096, 768, torch.int16, 0), (2048, 1024, torch.int16, 0),
    (4, 1024, torch.int16, 0), (256, 1024, torch.int8, 0),
    (37, 1000, torch.int8, 0), (5, 768, torch.int16, 1),
    (6, 4104, torch.int16, 0), (3, 16, torch.int8, 1)])
def test_wrapper_launch_arguments(R, D, xt, offset):
    """``_launch`` / ``_launch_ln_fwd`` pass the plan's wr, gpb and nb (wr
    0 for the any-shape body: D, or a base one element off), and ``wr=0``
    forces the any-shape body."""
    int_norm._sms.clear()
    int_norm._sms[torch.device("cpu")] = 132          # an H100's SMs
    lib = _FakeLib()
    xm = torch.zeros(R * D + offset, dtype=xt)[offset:].view(R, D)
    e = torch.zeros((), dtype=torch.int32)
    gamma = torch.ones(D)
    int_norm._launch_ln_fwd(lib, xm, e, gamma, gamma, 1e-5, False, 0)
    int_norm._launch(lib, xm, e, gamma, 1e-6, True, 0)
    int_norm._launch_ln_fwd(lib, xm, e, gamma, gamma, 1e-5, True, 0, wr=0)
    int_norm._launch(lib, xm, e, gamma, 1e-6, False, 0, wr=0)
    aligned = xm.data_ptr() % (VEC * xm.element_size()) == 0
    wr = int_norm.fwd_warps_per_row(D, aligned)
    assert wr == (0 if offset else int_norm.fwd_warps_per_row(D, True))
    plan = (wr,) + int_norm.fwd_blocks(R, wr, 132) if wr else (0, 0, 0)
    assert [c[0] for c in lib.calls] == ["ln", "rms"] * 2
    for i, (kind, args) in enumerate(lib.calls):
        assert tuple(args[-8:-6]) == (R, D)
        assert tuple(args[-4:-1]) == (plan if i < 2 else (0, 0, 0))
        assert args[-5] == (1 if i in (1, 2) else 0)    # integer_rsqrt
    int_norm._sms.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("xt,lim", [(torch.int16, 2047), (torch.int8, 127)])
@pytest.mark.parametrize("integer_rsqrt", [False, True])
def test_register_body_on_card(xt, lim, integer_rsqrt):
    """On the card: the register body's y, mu and rstd bit for bit against
    the any-shape body (the same exact int32 sums, the same f32
    expressions), and against the plain version (PyTorch's IEEE sqrt and
    division, one rounding per operation)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the chip)")
    from repro_torch.kernels import _lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(lim)
    lib, st = _lib.load(), _lib.stream_of(torch.empty(1, device=dev))
    for R, D in ((37, 768), (5, 1024), (9, 2048), (3, 576)):
        xm = torch.randint(-lim, lim + 1, (R, D), generator=gen,
                           device=dev).to(xt)
        xm[0] = xm[0, 0]                          # variance clamped at 0
        e = torch.tensor(-10, dtype=torch.int32, device=dev)
        gamma = 1 + 0.2 * torch.randn((D,), generator=gen, device=dev)
        beta = 0.1 * torch.randn((D,), generator=gen, device=dev)
        assert int_norm.fwd_warps_per_row(D, True)
        for got, rows, ref in (
                (int_norm._launch_ln_fwd(lib, xm, e, gamma, beta, 1e-5,
                                         integer_rsqrt, st),
                 int_norm._launch_ln_fwd(lib, xm, e, gamma, beta, 1e-5,
                                         integer_rsqrt, st, wr=0),
                 int_norm.int_layernorm_fwd_plain(
                     xm, e, gamma, beta, integer_rsqrt=integer_rsqrt)),
                (int_norm._launch(lib, xm, e, gamma, 1e-6, integer_rsqrt,
                                  st),
                 int_norm._launch(lib, xm, e, gamma, 1e-6, integer_rsqrt,
                                  st, wr=0),
                 int_norm.int_rmsnorm_fwd_plain(
                     xm, e, gamma, integer_rsqrt=integer_rsqrt))):
            for a, b, c in zip(got, rows, ref):
                assert torch.equal(a, b)
                assert torch.equal(a, c)
