"""The plans of K1's one-launch forward, K1's and K2's streaming
backwards (``ins_stats_plan``, ``ins_bwd_plan``, ``bn_bwd_plan``): pure
functions of the shape and the card, checked here on the CPU at every
model shape and at edge shapes.  A thread-level numpy emulation of each
kernel's indexing (the lanes, row steps, chunks, the warp butterfly and
the cluster's add of ``csrc/ins_stats.cu``'s forward; the tiles, chunks
and per-(sample, channel) statistics of its backward; the tiles and
chunks of ``csrc/bn_stats.cu``'s backward) holds that every element is
read or written once and every sum reaches, and every statistic comes
from, its (sample, channel).  The kernels themselves run only on the
card (``tests/test_torch_kernels_cuda.py``)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cnsn_tpu_torch.ops.kernels.bn_stats import (BWD_THREADS, BWD_UNROLL,
                                                bn_bwd_plan)
from cnsn_tpu_torch.ops.kernels.ins_stats import (BWD_UNROLL as K1_UNROLL,
                                                 MAX_CLUSTER, MIN_BATCHES,
                                                 THREADS, ins_bwd_plan,
                                                 ins_stats_plan)
from cnsn_tpu_torch.utils.stats_sweep import SN_R50, SN_WRN, bn_shapes
from test_torch_threads import one_thread  # noqa: F401 (autouse)


H100 = dict(sms=132, smem_per_sm=233472)
BF16, F32 = torch.bfloat16, torch.float32
# K1's calls on the main paths, b=128: ResNet-50's SelfNorm sites, the
# image CrossNorm statistics, WRN-40-2's SelfNorm and CrossNorm sites
K1_MAIN = ([(128, s * s, c, BF16, 8) for s, c in SN_R50 + SN_WRN]
           + [(128, 224 * 224, 3, F32, 1)])
# K1's backward calls: ResNet-50's SelfNorm sites and WRN-40-2's at pos
# 'pre' (sn.yaml) and pos 'post' (cnsn.yaml: 3 of the same 4 shapes), b=128
K1_BWD_MAIN = [(128, s * s, c, BF16, 8) for s, c in SN_R50 + SN_WRN]
# K2's calls: ResNet-50's and WRN-40-2's BatchNorm2d inputs, b=128 bf16
K2_MAIN = ([(128 * s * s, c) for s, c in bn_shapes()]
           + [(128 * s * s, c) for s, c in SN_WRN])


def _k1_invariants(p, n, hw, c, vec, wave_checked=True,
                   forced_lanes=False):
    assert p["lanes"] in (1, 2, 4, 8, 16, 32, 64, 128, 256)
    assert p["tile"] == p["lanes"] * vec and p["step"] * p["lanes"] == THREADS
    per_row = -(-c // vec)
    if not forced_lanes:
        # as few lanes as span the row, up to a whole block
        assert p["lanes"] >= min(per_row, THREADS)
        assert p["lanes"] < 2 * per_row or p["lanes"] == 1
    # the tiles cover [0, c) once
    assert (p["ctiles"] - 1) * p["tile"] < c <= p["ctiles"] * p["tile"]
    # one cluster a plane
    assert p["split"] in (1, 2, 4, 8) and p["split"] <= MAX_CLUSTER
    # the chunks cover [0, hw) once, in whole row steps
    cr = p["chunk_rows"]
    assert cr % p["step"] == 0 and p["split"] * cr >= hw
    rows = [r for k in range(p["split"])
            for r in range(k * cr, min(hw, (k + 1) * cr))]
    assert rows == list(range(hw))
    planes = n * p["ctiles"]
    assert p["blocks"] == planes * p["split"]
    if wave_checked:
        # one wave, unless the planes alone exceed it; a plane split only
        # while the card holds fewer blocks than SMs or each block keeps
        # MIN_BATCHES unrolled load steps a thread, and no further than
        # that rule and one cluster allow
        assert p["split"] == 1 or p["blocks"] <= p["wave"]
        sms = p["wave"] // p["blocks_per_sm"]
        assert p["split"] == 1 or (planes * p["split"] <= sms or
                                   p["batches"] >= p["split"] * MIN_BATCHES)
        more = 2 * p["split"]
        assert more > MAX_CLUSTER or planes * more > p["wave"] or (
            planes * more > sms and p["batches"] < more * MIN_BATCHES)


@pytest.mark.parametrize("n,hw,c,dtype,vec", K1_MAIN)
def test_k1_plan_at_the_main_paths(n, hw, c, dtype, vec):
    """Every K1 call of both models: covered once, one wave, one cluster
    a plane, four blocks an SM."""
    p = ins_stats_plan(n, hw, c, dtype, vec, **H100)
    _k1_invariants(p, n, hw, c, vec)
    assert p["blocks_per_sm"] == 4


@pytest.mark.parametrize("shape,want", [
    ((128, 56 * 56, 256), (32, 1, 2)),
    ((128, 28 * 28, 512), (64, 1, 1)),
    ((128, 14 * 14, 1024), (128, 1, 1)),
    ((128, 7 * 7, 2048), (256, 1, 1)),
    ((128, 32 * 32, 16), (2, 1, 1)),
    ((128, 32 * 32, 32), (4, 1, 1)),
    ((128, 16 * 16, 64), (8, 1, 1)),
    ((128, 8 * 8, 128), (16, 1, 1)),
])
def test_k1_plan_of_each_bf16_site(shape, want):
    """(lanes, channel tiles, blocks per plane) at each bf16 site: one
    tile a sample, one block a plane but at 56x56x256, whose block would
    take 49 unrolled load steps a thread (a cluster of 2)."""
    p = ins_stats_plan(*shape, BF16, 8, **H100)
    assert (p["lanes"], p["ctiles"], p["split"]) == want


def test_k1_plan_of_the_image_statistics():
    """C = 3 fp32 takes one-element loads: 4 lanes (one idle), 64 rows a
    step, 2 blocks a plane at b=128; a few images take one cluster of 8
    a plane."""
    p = ins_stats_plan(128, 224 * 224, 3, F32, 1, **H100)
    assert (p["lanes"], p["tile"], p["split"]) == (4, 4, 2)
    few = ins_stats_plan(2, 224 * 224, 3, F32, 1, **H100)
    _k1_invariants(few, 2, 224 * 224, 3, 1)
    assert few["split"] == MAX_CLUSTER and few["blocks"] == 16


@pytest.mark.parametrize("split,want", [(1, 1), (3, 2), (8, 8), (12, 8),
                                        (16, 8), (100, 8)])
def test_k1_forced_split_rounds_to_what_the_kernel_takes(split, want):
    p = ins_stats_plan(4, 28 * 28, 128, BF16, 8, **H100, split=split)
    assert p["split"] == want
    _k1_invariants(p, 4, 28 * 28, 128, 8, wave_checked=False)


@pytest.mark.parametrize("n,hw,c,dtype,vec", [
    (1, 224 * 224, 3, F32, 1), (2, 300 * 300, 8, BF16, 8),
    (1, 512 * 512, 64, BF16, 8)])
def test_k1_plan_keeps_a_plane_in_one_cluster(n, hw, c, dtype, vec):
    """Planes too few to fill the card, and large enough that each of
    many blocks would still keep its load steps, take one cluster of 8:
    the kernel adds a plane's blocks over one cluster's shared memory."""
    p = ins_stats_plan(n, hw, c, dtype, vec, **H100)
    _k1_invariants(p, n, hw, c, vec)
    assert p["split"] == MAX_CLUSTER


def test_k1_plan_residency_follows_shared_memory():
    """Four blocks an SM where shared memory holds them (the registers'
    limit), fewer where it does not."""
    assert ins_stats_plan(128, 49, 2048, BF16, 8, sms=132,
                          smem_per_sm=100_000)["blocks_per_sm"] == 2
    assert ins_stats_plan(128, 49, 2048, F32, 4, sms=132,
                          smem_per_sm=233472)["blocks_per_sm"] == 4


def test_k1_plan_refuses_a_vector_the_type_has_no_kernel_for():
    with pytest.raises(ValueError, match="loads 4"):
        ins_stats_plan(2, 9, 16, BF16, 4, **H100)


@settings(max_examples=150, deadline=None, database=None)
@given(n=st.integers(1, 300), hw=st.integers(1, 70_000),
       c=st.integers(1, 4096), wide=st.booleans(),
       dtype=st.sampled_from([F32, BF16]), sms=st.integers(1, 200),
       split=st.integers(0, 300))
def test_k1_plan_invariants(n, hw, c, wide, dtype, sms, split):
    vec = 16 // dtype.itemsize if wide else 1
    c = -(-c // vec) * vec
    p = ins_stats_plan(n, hw, c, dtype, vec, sms, 233472, split=split)
    _k1_invariants(p, n, hw, c, vec, wave_checked=split == 0)


def _emulate_k1(x, p, vec):
    """csrc/ins_stats.cu's forward sums, thread by thread in float64: each
    thread's rows (lane = t & (lanes−1), rows r_begin + t / lanes +
    j·step), the butterfly over lane bits ≥ lanes where lanes < 32, the
    slots of span = max(lanes, 32) threads into red[slot·tile + col] and
    added in slot order, then the cluster's ranks in order.  Returns (S1, S2) of shape (n, c) and the times each
    element was read."""
    n, hw, c = x.shape
    lanes, step, tile = p["lanes"], p["step"], p["tile"]
    t = np.arange(THREADS)
    lane = t & (lanes - 1)
    span = max(lanes, 32)
    reads = np.zeros(x.shape, dtype=np.int64)
    s = np.zeros((2, n, c))
    for b in range(n):
        for ct in range(p["ctiles"]):
            cbase = ct * tile
            parts = []
            for k in range(p["split"]):
                r0 = k * p["chunk_rows"]
                r1 = min(r0 + p["chunk_rows"], hw)
                acc = np.zeros((2, THREADS, vec))
                for th in range(THREADS):
                    c0 = cbase + lane[th] * vec
                    if c0 >= c:
                        continue
                    for r in range(r0 + th // lanes, r1, step):
                        v = x[b, r, c0:c0 + vec]
                        reads[b, r, c0:c0 + vec] += 1
                        acc[0, th] += v
                        acc[1, th] += v * v
                off = lanes
                while off < 32:  # butterfly: every thread ends with the sum
                    acc = acc + acc[:, t ^ off]
                    off *= 2
                red = np.full((2, THREADS * vec), np.nan)
                for th in range(THREADS):
                    if th % span < lanes:
                        o = (th // span) * tile + lane[th] * vec
                        red[:, o:o + vec] = acc[:, th]
                slots = THREADS // span
                mine = sum(red[:, k * tile:(k + 1) * tile]
                           for k in range(slots))
                parts.append(mine)
            cols = min(tile, c - cbase)
            s[:, b, cbase:cbase + cols] = sum(parts)[:, :cols]
    return s, reads


@pytest.mark.parametrize("n,hw,c,dtype,vec,split,lanes", [
    (2, 32 * 32, 16, BF16, 8, 0, 0),    # WRN's 32x32x16: 2 lanes
    (3, 8 * 8, 128, BF16, 8, 0, 0),     # 16 lanes
    (2, 7 * 7, 2048, BF16, 8, 0, 0),    # 256 lanes: a step is one row
    (2, 7 * 7, 2048, BF16, 8, 0, 32),   # 8 channel tiles of 32 lanes
    (2, 9, 512, F32, 4, 0, 0),          # 128 lanes, 2 slots of 4 warps
    (2, 37, 3, F32, 1, 0, 0),           # C = 3: a lane idle
    (1, 23, 33, F32, 1, 0, 0),          # 64 lanes, 31 of them idle
    (1, 23, 33, F32, 1, 0, 32),         # a ragged second tile of one channel
    (2, 9, 24, BF16, 8, 0, 0),          # 3 lanes of vectors round up to 4
    (1, 1, 40, F32, 4, 0, 0),           # H·W = 1
    (2, 300, 8, BF16, 8, 8, 0),         # clusters of 8
    (1, 1000, 3, F32, 1, 8, 0),         # C = 3 over a cluster of 8
    (1, 9, 1024, BF16, 8, 8, 0),        # a cluster of 8, some blocks
                                        # without rows, 128 lanes
])
def test_k1_emulated_kernel_reads_each_element_once(n, hw, c, dtype, vec,
                                                    split, lanes):
    p = ins_stats_plan(n, hw, c, dtype, vec, sms=4, smem_per_sm=233472,
                       split=split, lanes=lanes)
    _k1_invariants(p, n, hw, c, vec, wave_checked=split == 0 and lanes == 0,
                   forced_lanes=lanes > 0)
    x = np.random.RandomState(hw + c).randn(n, hw, c)
    s, reads = _emulate_k1(x, p, vec)
    assert (reads == 1).all()
    np.testing.assert_allclose(s[0], x.sum(1), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(s[1], (x * x).sum(1), rtol=1e-12)


def _k2_bwd_invariants(p, rows, c, vec, auto=True):
    assert 1 <= p["lanes"] <= BWD_THREADS
    assert p["lanes"] == min(-(-c // vec), BWD_THREADS)
    assert p["tile"] == p["lanes"] * vec
    assert p["step"] == BWD_THREADS // p["lanes"]
    assert (p["ctiles"] - 1) * p["tile"] < c <= p["ctiles"] * p["tile"]
    cr = p["chunk_rows"]
    assert cr % p["step"] == 0
    # the chunks cover [0, rows) once, none of them empty
    assert (p["chunks"] - 1) * cr < rows <= p["chunks"] * cr
    assert p["blocks"] == p["chunks"] * p["ctiles"]
    if auto:
        steps = -(-rows // p["step"])
        assert p["blocks"] <= max(p["wave"], p["ctiles"])
        assert p["chunks"] <= -(-steps // BWD_UNROLL)


@pytest.mark.parametrize("rows,c", K2_MAIN)
def test_k2_bwd_plan_at_the_main_paths(rows, c):
    """Every BatchNorm2d input of both models at b=128 bf16: one tile
    holds every channel, one wave, rows in whole steps, and the card
    filled where the rows allow (each block takes one unrolled step a
    thread at least)."""
    p = bn_bwd_plan(rows, c, BF16, 8, H100["sms"])
    _k2_bwd_invariants(p, rows, c, 8)
    assert p["ctiles"] == 1
    steps = -(-rows // p["step"])
    assert 10 * p["blocks"] >= 9 * min(p["wave"], -(-steps // BWD_UNROLL))


@settings(max_examples=150, deadline=None, database=None)
@given(rows=st.integers(1, 3_000_000), c=st.integers(1, 4096),
       wide=st.booleans(), dtype=st.sampled_from([F32, BF16]),
       sms=st.integers(1, 200), chunks=st.integers(0, 3000))
def test_k2_bwd_plan_invariants(rows, c, wide, dtype, sms, chunks):
    vec = 16 // dtype.itemsize if wide else 1
    c = -(-c // vec) * vec
    p = bn_bwd_plan(rows, c, dtype, vec, sms, chunks=chunks)
    _k2_bwd_invariants(p, rows, c, vec, auto=chunks == 0)


@pytest.mark.parametrize("rows,c,vec,chunks", [
    (15, 64, 8, 0),       # fewer rows than a block step
    (1, 3, 1, 0),         # one row, three channels
    (333, 96, 4, 0),      # 24 lanes: 16 threads idle
    (70, 2048, 8, 0),     # 256 lanes: a block step is one row
    (40, 4096, 8, 0),     # two tiles of 2048
    (1000, 33, 1, 7),     # forced chunks, one-element lanes
])
def test_k2_bwd_emulated_kernel_writes_each_element_once(rows, c, vec,
                                                         chunks):
    """csrc/bn_stats.cu's backward indexing: block (k, t), thread th at
    rin = th / lanes, c0 = t·tile + (th − rin·lanes)·vec, rows r_begin +
    rin + j·step; live threads only."""
    p = bn_bwd_plan(rows, c, BF16 if vec == 8 else F32, vec, 3,
                    chunks=chunks)
    _k2_bwd_invariants(p, rows, c, vec, auto=chunks == 0)
    writes = np.zeros((rows, c), dtype=np.int64)
    lanes, step = p["lanes"], p["step"]
    for k in range(p["chunks"]):
        r0 = k * p["chunk_rows"]
        r1 = min(r0 + p["chunk_rows"], rows)
        for ct in range(p["ctiles"]):
            for th in range(BWD_THREADS):
                rin = th // lanes
                c0 = ct * p["tile"] + (th - rin * lanes) * vec
                if rin >= step or c0 >= c:
                    continue
                for r in range(r0 + rin, r1, step):
                    writes[r, c0:c0 + vec] += 1
    assert (writes == 1).all()


def _k1_bwd_invariants(p, n, hw, c, vec, auto=True):
    per_row = -(-c // vec)
    # as few lanes, a power of two, as span the row, up to a whole block
    assert p["lanes"] in (1, 2, 4, 8, 16, 32, 64, 128, 256)
    assert p["lanes"] >= min(per_row, THREADS)
    assert p["lanes"] < 2 * per_row or p["lanes"] == 1
    assert p["tile"] == p["lanes"] * vec and p["step"] * p["lanes"] == THREADS
    assert (p["ctiles"] - 1) * p["tile"] < c <= p["ctiles"] * p["tile"]
    cr = p["chunk_rows"]
    assert cr % p["step"] == 0
    # the chunks cover a plane's [0, hw) once, none of them empty
    assert (p["chunks"] - 1) * cr < hw <= p["chunks"] * cr
    planes = n * p["ctiles"]
    assert p["blocks"] == p["chunks"] * planes
    if auto:
        # one wave (unless the planes alone exceed it), and at least one
        # unrolled step a thread: no more chunks than that allows
        steps = -(-hw // p["step"])
        assert p["blocks"] <= max(p["wave"], planes)
        assert p["chunks"] <= -(-steps // K1_UNROLL)
        # and chunks no longer than covering a plane in as many as those
        # two allow needs
        most = max(1, min(p["wave"] // planes, -(-steps // K1_UNROLL)))
        assert (cr // p["step"] - 1) * most < steps


@pytest.mark.parametrize("n,hw,c,dtype,vec", K1_BWD_MAIN)
def test_k1_bwd_plan_at_the_main_paths(n, hw, c, dtype, vec):
    """Every K1-backward call of both models: one tile a sample, one wave,
    rows in whole steps, each block an unrolled step a thread or more."""
    p = ins_bwd_plan(n, hw, c, dtype, vec, H100["sms"])
    _k1_bwd_invariants(p, n, hw, c, vec)
    assert p["ctiles"] == 1 and p["blocks"] <= p["wave"]


@pytest.mark.parametrize("shape,want", [
    ((128, 56 * 56, 256), (32, 4, 784)),
    ((128, 28 * 28, 512), (64, 4, 196)),
    ((128, 14 * 14, 1024), (128, 4, 50)),
    ((128, 7 * 7, 2048), (256, 4, 13)),
    ((128, 32 * 32, 16), (2, 4, 256)),
    ((128, 32 * 32, 32), (4, 4, 256)),
    ((128, 16 * 16, 64), (8, 4, 64)),
    ((128, 8 * 8, 128), (16, 2, 32)),
])
def test_k1_bwd_plan_of_each_bf16_site(shape, want):
    """(lanes, chunks a plane, rows a chunk): the 128 planes of each
    site take 4 chunks (a wave of 528 blocks holds 512) but 8x8x128's,
    whose 4 row steps (16 lanes, 16 rows a step) make 2 chunks of one
    unrolled step each; C = 16 takes 2 lanes, 128 rows a step."""
    p = ins_bwd_plan(*shape, BF16, 8, H100["sms"])
    assert (p["lanes"], p["chunks"], p["chunk_rows"]) == want


@pytest.mark.parametrize("n,hw,c,dtype,vec,want", [
    (128, 224 * 224, 3, F32, 1, (4, 4)),  # C = 3: 4 lanes, one idle
    (128, 56 * 56, 12, BF16, 1, (16, 4)),  # C = 12 bf16: no 16-byte loads
    (128, 7 * 7, 12, BF16, 1, (16, 2)),   # 4 row steps: 2 chunks
    (128, 1, 64, BF16, 8, (8, 1)),        # H·W = 1: one row, one chunk
    (1, 56 * 56, 256, BF16, 8, (32, 196)),  # N = 1: the rows fill the card
    (1, 1, 3, F32, 1, (4, 1)),            # one element a channel
    (2, 9, 4096, BF16, 8, (256, 5)),      # two tiles a sample
])
def test_k1_bwd_plan_edges(n, hw, c, dtype, vec, want):
    p = ins_bwd_plan(n, hw, c, dtype, vec, H100["sms"])
    _k1_bwd_invariants(p, n, hw, c, vec)
    assert (p["lanes"], p["chunks"]) == want


def test_k1_bwd_plan_refuses_a_vector_the_type_has_no_kernel_for():
    with pytest.raises(ValueError, match="loads 8"):
        ins_bwd_plan(2, 9, 16, F32, 8, 132)


@settings(max_examples=150, deadline=None, database=None)
@given(n=st.integers(1, 300), hw=st.integers(1, 70_000),
       c=st.integers(1, 4096), wide=st.booleans(),
       dtype=st.sampled_from([F32, BF16]), sms=st.integers(1, 200),
       chunks=st.integers(0, 3000))
def test_k1_bwd_plan_invariants(n, hw, c, wide, dtype, sms, chunks):
    vec = 16 // dtype.itemsize if wide else 1
    c = -(-c // vec) * vec
    p = ins_bwd_plan(n, hw, c, dtype, vec, sms, chunks=chunks)
    _k1_bwd_invariants(p, n, hw, c, vec, auto=chunks == 0)


def _emulate_k1_bwd(x, mean, std, gm, gs, p, vec, ddof=1):
    """csrc/ins_stats.cu's backward, thread by thread in float64: block
    (k, t, b), thread th at rin = th / lanes, c0 = t·tile + (th −
    rin·lanes)·vec, its statistics at b·c + c0, its rows r_begin + rin +
    u·step in unrolled steps of K1_UNROLL; live threads only.  Returns dx
    and the times each element was written."""
    n, hw, c = x.shape
    flat = [a.reshape(-1) for a in (mean, std, gm, gs)]
    dx = np.full(x.shape, np.nan)
    writes = np.zeros(x.shape, dtype=np.int64)
    lanes, step = p["lanes"], p["step"]
    denom = max(hw - ddof, 1)
    for b in range(n):
        for ct in range(p["ctiles"]):
            for k in range(p["chunks"]):
                r0 = k * p["chunk_rows"]
                r1 = min(r0 + p["chunk_rows"], hw)
                for th in range(THREADS):
                    rin = th // lanes
                    c0 = ct * p["tile"] + (th - rin * lanes) * vec
                    if c0 >= c:
                        continue
                    at = b * c + c0
                    m, sd, g1, g2 = (f[at:at + vec] for f in flat)
                    a, den = g1 / hw, denom * sd
                    for r in range(r0 + rin, r1, K1_UNROLL * step):
                        for u in range(K1_UNROLL):
                            row = r + u * step
                            if row < r1:
                                v = x[b, row, c0:c0 + vec]
                                dx[b, row, c0:c0 + vec] = (
                                    a + g2 * (v - m) / den)
                                writes[b, row, c0:c0 + vec] += 1
    return dx, writes


@pytest.mark.parametrize("n,hw,c,vec,chunks", [
    (2, 32 * 32, 16, 8, 0),    # WRN's 32x32x16: 2 lanes, 128 rows a step
    (3, 8 * 8, 128, 8, 0),     # 16 lanes, 4 steps: one chunk
    (2, 7 * 7, 2048, 8, 0),    # 256 lanes: a step is one row
    (2, 9, 4096, 8, 0),        # two tiles a sample
    (2, 37, 3, 1, 0),          # C = 3: a lane idle
    (1, 23, 12, 1, 0),         # C = 12 bf16 on one-element lanes
    (3, 1, 40, 4, 0),          # H·W = 1
    (1, 300, 8, 8, 0),         # N = 1: chunks fill the card
    (2, 300, 24, 8, 7),        # forced chunks; 3 lanes of vectors round up
    (1, 1000, 33, 1, 5),       # forced chunks, 64 lanes, 31 idle
])
def test_k1_bwd_emulated_kernel_writes_each_element_once(n, hw, c, vec,
                                                         chunks):
    """Every dx element written once, from its own (sample, channel)'s
    statistics: each statistic differs, so a misread one shows."""
    p = ins_bwd_plan(n, hw, c, F32 if vec == 4 else BF16, vec, 3,
                     chunks=chunks)
    _k1_bwd_invariants(p, n, hw, c, vec, auto=chunks == 0)
    rng = np.random.RandomState(n * hw + c)
    x = rng.randn(n, hw, c)
    mean, gm, gs = (rng.randn(n, c) for _ in range(3))
    std = rng.uniform(0.5, 2.0, (n, c))
    dx, writes = _emulate_k1_bwd(x, mean, std, gm, gs, p, vec)
    assert (writes == 1).all()
    want = (gm[:, None] / hw + gs[:, None] * (x - mean[:, None])
            / (max(hw - 1, 1) * std[:, None]))
    np.testing.assert_allclose(dx, want, rtol=1e-13, atol=1e-13)
