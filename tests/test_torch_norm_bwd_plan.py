"""The norm backwards' launch plan and index math, rehearsed on the CPU.

``csrc/int_norm.cu`` runs ``int_layernorm_bwd`` / ``int_rmsnorm_bwd`` as
one cooperative launch: ``norm_bwd_cached`` (a group of ``wr`` warps per
row, 2 units of 8 columns a lane kept in registers) or ``norm_bwd_rows``
(any shape: a block per row, scalar columns), then, after a grid barrier,
``bwd_column_sums`` over the blocks' partial rows.  The functions below
are numpy models of the kernels' index math, line for line: which rows a
block's groups take, which columns a lane's units hold, which shared-memory
slot a column's partial lands in and is read back from, and which columns
and partial rows the final sums read.  The tests show that every row,
column and element is covered exactly once at the configs' widths (D =
128, 576, 768, 1024, 2048), the tests' (7, 1000, 4104) and R in {0, 1, 37,
2048, 4096, 4608}, and hold the Python plan (``int_norm.bwd_warps_per_row``
/ ``bwd_blocks``) and the wrapper's launch arguments against it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import int_norm  # noqa: E402

WARPS, VEC, UNITS = int_norm.BWD_WARPS, int_norm.BWD_VEC, 2
WARP_COLS = int_norm.BWD_WARP_COLS
THREADS, SLICE = 32 * WARPS, 8
SLICE_GROUPS = THREADS // SLICE

WIDTHS = [128, 576, 768, 1024, 2048, 7, 1000, 4104]
ROWS = [0, 1, 37, 2048, 4096, 4608]
#: co-resident blocks on an H100 (132 SMs) at 1-3 blocks per SM
RESIDENT = [132, 264, 396]


def cached_rows(R, wr, nb):
    """norm_bwd_cached: the rows of every group, (nb * 8 / wr) lists —
    group grp of block b takes rows b * gpb + grp + j * nb * gpb."""
    gpb = WARPS // wr
    groups = nb * gpb
    return [np.arange(b * gpb + grp, R, groups)
            for b in range(nb) for grp in range(gpb)]


def cached_columns(D, wr):
    """norm_bwd_cached: (warp position q, unit k, lane, element e) ->
    column, for the units u = (q * UNITS + k) * 32 + lane < D / 8 that are
    loaded; returns the columns and the shared-memory offset each lands at
    within its warp's slice ((k * 32 + lane) * 8 + e)."""
    q, k, lane, e = np.meshgrid(np.arange(wr), np.arange(UNITS),
                                np.arange(32), np.arange(VEC), indexing="ij")
    u = (q * UNITS + k) * 32 + lane
    live = u < D // VEC
    col = u * VEC + e
    slot = q * WARP_COLS + (k * 32 + lane) * VEC + e
    return col[live], slot[live]


def rows_path(R, D, nb):
    """norm_bwd_rows: block b takes rows b, b + nb, ...; thread t columns
    t, t + 256, ..."""
    rows = [np.arange(b, R, nb) for b in range(nb)]
    cols = [np.arange(t, D, THREADS) for t in range(THREADS)]
    return rows, cols


def column_sums(D, nb):
    """bwd_column_sums: the (partial row, column) pairs each thread of each
    block adds, and the column each block's thread e < 8 writes."""
    reads, writes = [], []
    slices = -(-D // SLICE)
    for b in range(nb):
        for s in range(b, slices, nb):
            for t in range(THREADS):
                c = s * SLICE + t % SLICE
                if c < D:
                    reads += [(p, c) for p in range(t // SLICE, nb,
                                                     SLICE_GROUPS)]
                    if t < SLICE:
                        writes.append(c)
    return reads, writes


def _once(counts):
    return counts.size == 0 or (counts.min() == 1 and counts.max() == 1)


def _plan(R, D, resident, aligned=True):
    wr = int_norm.bwd_warps_per_row(D, aligned)
    return wr, int_norm.bwd_blocks(R, wr, resident)


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("aligned", [True, False])
def test_warps_per_row(D, aligned):
    wr = int_norm.bwd_warps_per_row(D, aligned)
    if not aligned or D % VEC or D > WARPS * WARP_COLS:
        assert wr == 0
    else:
        assert wr in (1, 2, 4, 8) and wr * WARP_COLS >= D
        assert wr == 1 or (wr // 2) * WARP_COLS < D      # the fewest warps


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("wr", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("resident", RESIDENT)
def test_blocks(R, wr, resident):
    nb = int_norm.bwd_blocks(R, wr, resident)
    per_block = WARPS // wr if wr else 1
    assert 1 <= nb <= resident
    assert nb == resident or nb * per_block >= R     # every row has a group
    assert nb == 1 or (nb - 1) * per_block < R       # no block without rows


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("resident", RESIDENT)
def test_rows_and_columns_covered_once(R, D, resident):
    """Rows over the groups (or blocks), columns over one group's lanes (or
    a block's threads): each exactly once, so every element once."""
    wr, nb = _plan(R, D, resident)
    if wr:
        rows = cached_rows(R, wr, nb)
        cols, _ = cached_columns(D, wr)
        assert cols.max() < D
        col_counts = np.bincount(cols, minlength=D)
    else:
        rows, cols = rows_path(R, D, nb)
        col_counts = np.bincount(np.concatenate(cols), minlength=D)
    row_counts = np.bincount(np.concatenate(rows).astype(np.int64),
                             minlength=R)
    assert len(row_counts) == R and _once(row_counts)
    assert len(col_counts) == D and _once(col_counts)


@pytest.mark.parametrize("R,D", [(37, 1000), (37, 576), (70, 8), (5, 2048),
                                 (3, 4104), (1, 7)])
def test_elements_covered_once(R, D):
    """The element count itself at small shapes (a few blocks)."""
    wr, nb = _plan(R, D, resident=4)
    counts = np.zeros((R, D), np.int64)
    if wr:
        cols, _ = cached_columns(D, wr)
        for rows in cached_rows(R, wr, nb):
            counts[np.ix_(rows, cols)] += 1
    else:
        rows, cols = rows_path(R, D, nb)
        for r in rows:
            for c in cols:
                counts[np.ix_(r, c)] += 1
    assert _once(counts)


@pytest.mark.parametrize("D", [w for w in WIDTHS if w % VEC == 0
                               and w <= WARPS * WARP_COLS])
def test_partial_slots(D):
    """norm_bwd_cached's block partial: column c of group j is read at
    j * wr * 512 + c; that slot is the one the group's warp holding c
    wrote (warp j * wr + q at q * 512 + its unit offset)."""
    wr = int_norm.bwd_warps_per_row(D, True)
    cols, slot = cached_columns(D, wr)
    for j in range(WARPS // wr):
        written = np.full(WARPS * WARP_COLS, -1)
        written[j * wr * WARP_COLS + slot] = cols
        assert np.array_equal(written[j * wr * WARP_COLS + np.arange(D)],
                              np.arange(D))


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("R", ROWS)
def test_column_sums_cover_partials_once(R, D):
    """bwd_column_sums reads every (partial row, column) once and writes
    every column of dgamma / dbeta once, at the plan's block count."""
    wr, nb = _plan(R, D, resident=264)
    reads, writes = column_sums(D, nb)
    pairs = np.array(reads, np.int64).reshape(-1, 2)
    counts = np.bincount(pairs[:, 0] * D + pairs[:, 1], minlength=nb * D)
    assert len(counts) == nb * D and _once(counts)
    assert _once(np.bincount(np.array(writes, np.int64), minlength=D))


class _FakeLib:
    """Records the launch arguments; the resident count of the register
    and the any-shape path."""

    def __init__(self, resident):
        self.resident, self.queries, self.calls = resident, [], []

    def int_norm_bwd_resident(self, dev, xb, gb, ln, cached):
        self.queries.append((xb, gb, ln, cached))
        return self.resident

    def int_layernorm_bwd_launch(self, *args):
        self.calls.append(("ln", args))
        return 0

    def int_rmsnorm_bwd_launch(self, *args):
        self.calls.append(("rms", args))
        return 0


@pytest.mark.parametrize("R,D,xt,gt,offset", [
    (2048, 1024, torch.int16, torch.int8, 0), (37, 1000, torch.int8,
                                               torch.int16, 0),
    (0, 7, torch.int16, torch.int8, 0), (5, 768, torch.int16, torch.int8, 1),
    (6, 7, torch.int8, torch.int8, 1)])
def test_wrapper_launch_arguments(R, D, xt, gt, offset):
    """``_launch_bwd`` passes the plan's wr and nb, sizes the partial rows
    (nb, D), and asks for the resident count once per key."""
    int_norm._resident.clear()
    lib = _FakeLib(resident=264)

    def mant(t):   # (R, D) at an element offset from the allocation
        return torch.zeros(R * D + offset, dtype=t)[offset:].view(R, D)
    xm, gm = mant(xt), mant(gt)
    e = torch.zeros((), dtype=torch.int32)
    gamma = torch.ones(D)
    stats = torch.ones(R, 1)
    for _ in range(2):
        int_norm._launch_bwd(lib, True, xm, gm, e, e, gamma, stats, stats,
                             0)
        int_norm._launch_bwd(lib, False, xm, gm, e, e, gamma, None, stats,
                             0)
    aligned = (xm.data_ptr() % (VEC * xm.element_size()) == 0
               and gm.data_ptr() % (VEC * gm.element_size()) == 0)
    wr = int_norm.bwd_warps_per_row(D, aligned)
    assert wr == (0 if offset else int_norm.bwd_warps_per_row(D, True))
    nb = int_norm.bwd_blocks(R, wr, 264)
    assert len(lib.queries) == 2                     # ln and rms, once each
    assert [c[0] for c in lib.calls] == ["ln", "rms"] * 2
    for kind, args in lib.calls:
        R_, D_, wr_, nb_ = args[-5:-1]
        assert (R_, D_, wr_, nb_) == (R, D, wr, nb)
    int_norm._resident.clear()
