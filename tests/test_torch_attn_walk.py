"""How K2-K5 find each row's window, and the walk counters beside them.

K2, K3, K4 and K5 (``csrc/wattn_fwd.cu``, ``wattn_rpe_fwd.cu``,
``wattn_rpe_bwd_q.cu``, ``wattn_rpe_bwd_k.cu``) walk each row's own window,
a run of equal rank among the window-sorted rows, found by
``wattn::warp_run_bounds`` from ballots of run-start flags: on the host
geometry's f32 ranks (K3-K5) and on the int32 ranks of K2's window sort.
``wattn_kernel.warp_run_bounds`` is that rule written in torch; it is held
here against ``wattn.run_bounds``, the port's plain run bounds, and
``wattn_kernel.walk_counts`` (the occupancy and lane-step counters of
``chip_smoke.py``'s K2-K5 rows) against counts by brute force. CPU only.
"""

import numpy as np
import pytest
import torch

from u2mkd_tpu_torch.data import wgeom_host
from u2mkd_tpu_torch.ops import wattn
from u2mkd_tpu_torch.ops.kernels import wattn_kernel

CASES = ["random", "long", "host_pads", "shared_pads", "one_window", "singletons"]


def _rank(case, rng):
    """A window-sorted rank [N] (float32, as the host geometry gives it)."""
    n = 1024
    if case == "random":       # windows of 1-9 rows
        sizes = rng.randint(1, 10, n)
    elif case == "long":       # windows longer than a tile, across tile bounds
        sizes = rng.choice([1, 2, 37, 130, 300], n)
    elif case == "host_pads":  # then 200 pad rows, each a window of one
        sizes = np.concatenate([rng.randint(1, 60, 40), np.ones(n, np.int64)])
    elif case == "shared_pads":  # then pads that share one rank (PAD_RANK)
        sizes = rng.randint(1, 60, 30)
        sizes = np.concatenate([sizes, [n]])
    elif case == "one_window":
        sizes = np.array([n])
    else:
        sizes = np.ones(n, np.int64)
    ids = np.repeat(np.arange(len(sizes)), sizes)[:n]
    if case == "shared_pads":
        ids = np.where(ids == len(sizes) - 1, wattn_kernel.PAD_RANK, ids)
    return torch.from_numpy(ids.astype(np.float32))


def _kranges(rank):
    """Per-128-row-tile key ranges as the host geometry builds them: from the
    start of the tile's first row's window to the end of its last row's."""
    start, end = wattn.run_bounds(wattn.window_starts(rank))
    kmin = start[::128].contiguous()
    return kmin, torch.maximum(end[127::128], kmin + 1).contiguous()


def _brute(rank, kmin, kmax):
    """Every count of :func:`wattn_kernel.walk_counts`, by loops over rows."""
    r = rank.tolist()
    n = len(r)
    start = [0] * n
    end = [0] * n
    for i in range(n):
        s = i
        while s > 0 and r[s - 1] == r[i]:
            s -= 1
        e = i + 1
        while e < n and r[e] == r[i]:
            e += 1
        start[i], end[i] = s, e
    occ = []
    i = 0
    while i < n:
        occ.append(end[i] - i)
        i = end[i]
    flag = [True] + [r[j] != r[j - 1] for j in range(1, n)] + [True] * 32

    def word(c):
        return any(flag[c:c + 32])

    ballots = []
    for base in range(0, n, 32):
        count = 1
        if not flag[base]:
            c = base - 32
            while True:
                count += 1
                if word(c):
                    break
                c -= 32
        c = base + 32
        while True:
            count += 1
            if word(c):
                break
            c += 32
        ballots.append(count)
    pairs = sum(o * o for o in occ)
    longest = [max(end[i] - start[i] for i in range(b, b + 32)) for b in range(0, n, 32)]
    return (start, end), {
        "occupancy_mean": float(np.mean(occ)),
        "occupancy_p99": float(np.percentile(np.array(occ, np.float64), 99)),
        "occupancy_max": max(occ), "pairs": pairs,
        "lane_steps_per_pair_tile": 128 * sum(b - a for a, b in zip(kmin.tolist(),
                                                                      kmax.tolist())) / pairs,
        "lane_steps_per_pair_window": sum(e - s for s, e in zip(start, end)) / pairs,
        "warp_slots_per_pair_window": 32 * sum(longest) / pairs,
        "ballots_per_warp": float(np.mean(ballots))}


@pytest.mark.parametrize("case", CASES)
def test_warp_run_bounds_match_run_bounds(case):
    """The kernels' ballot rule gives every row the run wattn.run_bounds
    gives it: windows longer than a warp or a tile, windows across warp and
    tile bounds, pads of one row or of one shared rank, one window of all N
    rows, all windows of one row."""
    rank = _rank(case, np.random.RandomState(3))
    start, end, ballots = wattn_kernel.warp_run_bounds(rank)
    want = wattn.run_bounds(wattn.window_starts(rank))
    assert torch.equal(start, want[0].long()) and torch.equal(end, want[1].long())
    assert ballots.shape == (rank.shape[0] // 32,) and int(ballots.min()) >= 2
    with pytest.raises(ValueError):
        wattn_kernel.warp_run_bounds(rank[:100])


@pytest.mark.parametrize("case", CASES)
def test_walk_counts_match_brute_force(case):
    """Occupancy, pairs, lane steps of the tile walk and of the window walk,
    warp slots and ballots, against loops over the rows."""
    rank = _rank(case, np.random.RandomState(5))
    kmin, kmax = _kranges(rank)
    (start, end), want = _brute(rank, kmin, kmax)
    got = wattn_kernel.walk_counts(rank, kmin, kmax)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["lane_steps_per_pair_window"] == 1.0
    assert wattn_kernel.warp_run_bounds(rank)[0].tolist() == start
    assert wattn_kernel.warp_run_bounds(rank)[1].tolist() == end


@pytest.mark.parametrize("radial", [False, True])
def test_walk_counts_on_host_geometry(radial):
    """On the host geometry of a random cloud (pads included, sphere windows
    of hundreds of rows): the counts agree with brute force, the tile walk
    takes more than one lane step per pair, and its ranges are the ones the
    geometry carries."""
    rng = np.random.RandomState(7)
    b, v, g = 2, 700, 6
    ws = (30.0, 30.0, 120.0) if radial else (4.0, 4.0, 4.0)
    xyz = rng.uniform(-8, 8, (b, v, 3)).astype(np.float32)
    valid = rng.rand(b, v) < 0.9
    coords = np.stack([wgeom_host.cart2sphere(x) for x in xyz]) if radial else xyz
    geo = wgeom_host.branch_geometry(coords, valid, ws, tuple(w / g for w in ws), 128, radial)
    rank = torch.from_numpy(geo["rank"])
    kmin, kmax = torch.from_numpy(geo["kmin"]), torch.from_numpy(geo["kmax"])
    assert torch.equal(torch.stack(_kranges(rank)), torch.stack([kmin, kmax]))
    _, want = _brute(rank, kmin, kmax)
    got = wattn_kernel.walk_counts(rank, kmin, kmax)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["lane_steps_per_pair_tile"] > 1.0
    assert got["occupancy_max"] >= int(geo["occ"][0])


SORT_CASES = ["mixed", "long", "one_window", "all_invalid"]


def _sorted_windows(case, rng):
    """K2's own geometry, from ``sort_by_window``: int32 ranks with pad rows
    at PAD_RANK (V off the tile) and each invalid row a window of its own."""
    ws = (1.0, 1.0, 1.0)
    if case == "mixed":        # a random cloud, 10% invalid rows
        v = 1000
        xyz = rng.uniform(-8, 8, (v, 3))
        valid = rng.rand(v) < 0.9
        ws = (2.0, 2.0, 2.0)
    elif case == "long":       # windows of 1-300 rows, across warp and tile bounds
        sizes = [40, 150, 300, 3, 70, 1, 300]
        xyz = np.concatenate([rng.uniform(0, 0.9, (s_, 3)) + [10.0 * w, 0, 0]
                              for w, s_ in enumerate(sizes)])
        valid = np.ones(len(xyz), bool)
        valid[rng.choice(len(xyz), 5, replace=False)] = False
    elif case == "one_window":  # all N rows in one window, no pad
        xyz = rng.uniform(0, 0.9, (512, 3))
        valid = np.ones(512, bool)
    else:                      # every row invalid: windows of one, then pads
        xyz = rng.uniform(-8, 8, (300, 3))
        valid = np.zeros(300, bool)
    sw = wattn_kernel.sort_by_window(torch.from_numpy(xyz.astype(np.float32)),
                                     torch.from_numpy(valid), ws)
    return sw, int(valid.sum()), len(valid)


@pytest.mark.parametrize("case", SORT_CASES)
def test_warp_run_bounds_on_window_sort(case):
    """K2's ballot rule on the int32 ranks of ``sort_by_window`` gives every
    row the run ``wattn.run_bounds`` gives it: pads share one run at
    PAD_RANK, each invalid row is a run of one, windows are longer than a
    warp and a tile, or one window holds all N rows."""
    sw, n_valid, v = _sorted_windows(case, np.random.RandomState(13))
    rank = sw.rank
    assert rank.dtype == torch.int32 and rank.shape[0] % 128 == 0
    start, end, ballots = wattn_kernel.warp_run_bounds(rank)
    want = wattn.run_bounds(wattn.window_starts(rank))
    assert torch.equal(start, want[0].long()) and torch.equal(end, want[1].long())
    assert ballots.shape == (rank.shape[0] // 32,) and int(ballots.min()) >= 2
    length = end - start
    n = rank.shape[0]
    assert (length[n_valid:v] == 1).all()                         # invalid rows alone
    assert (rank[v:] == wattn_kernel.PAD_RANK).all()
    assert (length[v:] == n - v).all()                            # pads: one run
    if case == "long":
        assert int(length.max()) > 128 and bool(((start // 128) != ((end - 1) // 128)).any())
    if case == "one_window":
        assert (start == 0).all() and (end == n).all()


@pytest.mark.parametrize("case", SORT_CASES)
def test_walk_counts_on_window_sort(case):
    """``walk_counts`` on K2's geometry (its tile ranges included) equals the
    counts by brute force, and the window walk takes one lane step per
    pair."""
    sw, _, _ = _sorted_windows(case, np.random.RandomState(17))
    (start, end), want = _brute(sw.rank, sw.kmin, sw.kmax)
    got = wattn_kernel.walk_counts(sw.rank, sw.kmin, sw.kmax)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["lane_steps_per_pair_window"] == 1.0
    assert wattn_kernel.warp_run_bounds(sw.rank)[0].tolist() == start
