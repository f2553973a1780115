"""The scatter routes' segment table and its executors
(``ops/audio_ops``: ``segment_table``, ``scatter_table`` and its plain
version, ``csrc/audio_scatter.cu``).

The table is held against the per-event rule it vectorises
(``_drop_segments`` after ``_as_starts``), run for run and in order; the
plain executor against the slice-add loop the scatter routes ran before
the table, bit for bit; on a card, the kernel against the plain version,
bit for bit, one launch a call.  No JAX here: the port's audio tests
against the JAX package are ``test_torch_audio.py``'s.
"""

import numpy as np
import pytest
import torch

from libnativecpurenderer_tpu_torch.ops import audio_ops as pops

torch.set_num_threads(1)

ROWS = 100
# (name, source rows a group, start frames a group) on a ROWS-row target
CASES = [
    ("in range", [30], [[0, 10, 70]]),
    ("cut short at the end", [30], [[80, 99]]),
    ("negative starts that wrap", [30], [[-5, -20, -30]]),
    ("below -rows", [30], [[-150, -101, -100, -129]]),
    ("at or past the end", [30], [[100, 130, 10**9]]),
    ("SENTINEL", [30], [[pops.SENTINEL, 3]]),
    ("duplicate starts", [30], [[7, 7, 7, -7, -7]]),
    ("int32-wrapping starts", [30],
     [[2**32 + 5, 2**31 + 3, -(2**31) - 4, 2**32 - 10]]),
    ("a source longer than the target", [260], [[-100, -40, 0, 50, -260]]),
    ("groups of every kind", [30, 260, 1, 0],
     [[-20, 99, 2**32 + 5], [-100, 10], [0, 99, 100, -1], [5]]),
]


def slice_add_loop(target, sources, src_lens, starts):
    """The scatter route as it ran before the table: groups in order,
    events in order, one in-place slice add a surviving run."""
    for k in range(len(src_lens)):
        src = sources[k][:int(src_lens[k])]
        for s in pops._as_starts(starts[k]):
            for a, b, d in pops._drop_segments(int(s), src.shape[0],
                                               target.shape[0]):
                target[d:d + b - a] += src[a:b]
    return target


def same_bits(a, b):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    ua = a.view(np.uint64 if a.itemsize == 8 else np.uint32)
    ub = b.view(np.uint64 if b.itemsize == 8 else np.uint32)
    bad = int((ua != ub).sum())
    assert bad == 0, f"{bad} samples differ, max {np.abs(a - b).max()}"


def order_sensitive(rng, shape, dtype):
    """Samples whose sums depend on their order: large and small
    magnitudes mixed (float32's and float64's)."""
    big = 1e7 if dtype == torch.float32 else 1e16
    x = rng.standard_normal(shape) * np.where(rng.random(shape) < 0.5, big,
                                              1.0)
    return torch.from_numpy(x).to(dtype)


def clips(rng, lens, channels, dtype):
    return [order_sensitive(rng, (n, channels), dtype) for n in lens]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("name,lens,starts", CASES, ids=[c[0] for c in CASES])
def test_segment_table_matches_drop_segments(name, lens, starts, channels):
    table, kept = pops.segment_table(ROWS, lens, starts)
    want, want_kept = [], 0
    for k, (n, st) in enumerate(zip(lens, starts)):
        for s in pops._as_starts(st):
            runs = pops._drop_segments(int(s), n, ROWS)
            want_kept += bool(runs)
            want += [(d, b - a, a, k) for a, b, d in runs]
    assert table.dtype == np.int64 and table.shape == (len(want), 4)
    assert [tuple(r) for r in table.tolist()] == want
    assert kept == want_kept
    # and the plain executor adds those runs as the slice-add loop did
    rng = np.random.default_rng(len(name))
    base = order_sensitive(rng, (ROWS, channels), torch.float64)
    src = clips(rng, [max(lens)] * len(lens), channels, torch.float64)
    got = pops.scatter_table(base.clone(), src, table)
    same_bits(got, slice_add_loop(base.clone(), src, lens, starts))
    # the target rows the runs span, which the card's launch covers
    span = (min(d for d, *_ in want), max(d + n for d, n, *_ in want)) \
        if want else (0, 0)
    assert pops._table_sources(base, src, table)[1:] == span


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_executor_sums_in_the_slice_add_loops_order(dtype):
    # two groups whose events overlap the same rows, on a non-zero base:
    # each group order gives the loop's bits, and the two orders differ
    rng = np.random.default_rng(31)
    rows = 400
    base = order_sensitive(rng, (rows, 2), dtype)
    a, b = clips(rng, [120, 90], 2, dtype)
    st_a, st_b = [0, 7, 7, 60, -30, 390], [5, 7, 50, -400, 330]
    runs = {}
    for order in ("ab", "ba"):
        src = [a, b] if order == "ab" else [b, a]
        lens = [120, 90] if order == "ab" else [90, 120]
        starts = [st_a, st_b] if order == "ab" else [st_b, st_a]
        got = base.clone()
        kept, n = pops._scatter(got, src, lens, starts)
        same_bits(got, slice_add_loop(base.clone(), src, lens, starts))
        runs[order] = (kept, n)
        table, _ = pops.segment_table(rows, lens, starts)
        same_bits(pops.scatter_table_reference(base.clone(), src, table),
                  got)
        if order == "ab":
            first = got
    assert runs["ab"] == runs["ba"] == (11, 12)
    assert not torch.equal(first, got)


def test_scatter_table_refuses_runs_outside_and_copies_aliased_sources():
    target = torch.zeros((10, 2), dtype=torch.float64)
    src = torch.ones((4, 2), dtype=torch.float64)
    for bad in ([[8, 4, 0, 0]], [[0, 5, 0, 0]], [[0, 2, 3, 0]],
                [[0, 2, 0, 1]], [[-1, 2, 0, 0]], [[0, 0, 0, 0]]):
        with pytest.raises(ValueError, match="outside"):
            pops.scatter_table(target, [src], np.array(bad, np.int64))
    with pytest.raises(ValueError, match=r"\(L, 2\)"):
        pops.scatter_table(target, [torch.ones((4, 1), dtype=torch.float64)],
                           np.zeros((0, 4), np.int64))
    # a source of another dtype: no hidden conversion, as the executor
    # adds in the target's dtype alone
    with pytest.raises(ValueError, match="float32"):
        pops.overlay(target, torch.ones((4, 2), dtype=torch.float32), 0)
    # a source that is a view of the target reads the target as it was
    # before the call, as the JAX op's source does
    target = torch.arange(20, dtype=torch.float64).reshape(10, 2)
    want = target.clone()
    want[2:6] += target[0:4].clone()
    pops.overlay(target, target[0:4], 2)
    same_bits(target, want)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: csrc/audio_scatter.cu runs only there")
    return torch.device("cuda", 0)


def whole_target(rng):
    """Rows over many tiles and not a whole number of them; events that
    wrap, cut short, drop and repeat; groups that overlap each other."""
    rows = 50_003
    lens = [int(n) for n in rng.integers(1, 9_000, 7)] + [60_000]
    starts = [np.concatenate([rng.integers(-rows - 100, rows + 100, 9),
                              [0, rows - 1, -1, pops.SENTINEL]])
              for _ in lens]
    return rows, lens, starts


def span_off_the_tile_grid(rng):
    """Runs inside rows that start and end off the kernel's 4,096-element
    tiles: the launch covers their tiles alone, and every row outside
    them keeps its bits."""
    return 70_001, [5_003, 777], [[31_337, 33_000], [36_001, 30_111]]


@pytest.mark.parametrize("events", [whole_target, span_off_the_tile_grid])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_equals_plain_version_one_launch_a_call(card, dtype,
                                                       channels, events):
    rng = np.random.default_rng(32)
    rows, lens, starts = events(rng)
    base = order_sensitive(rng, (rows, channels), dtype)
    src = clips(rng, lens, channels, dtype)
    want = base.clone()
    runs = pops._scatter(want, src, lens, starts)[1]
    got = base.to(card)
    src_card = [s.to(card) for s in src]
    launches = pops.scatter_table.launches
    segments = pops.overlay_groups.segments
    pops.overlay_groups(got, src_card, lens, starts)
    torch.cuda.synchronize()
    assert pops.scatter_table.launches - launches == 1
    assert pops.overlay_groups.segments - segments == runs
    same_bits(got, want)
    # nothing to add: no upload, no launch
    pops.overlay_groups(got, src_card, lens, [[rows]] * len(lens))
    assert pops.scatter_table.launches - launches == 1
