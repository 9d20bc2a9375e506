"""Launch plans of the port's batch-norm kernels, on the CPU.

The training forward (``ops/fused_bn.py``, ``train_fwd_plan``) and the
training backward (``ops/fused_bn_bwd.py``, ``train_bwd_plan``) are each
one cooperative launch of a persistent grid that keeps each chunk's rows
in shared memory; the given-statistics forward (``ops/fused_bn.py``,
``norm_plan``) is one wave of resident CTAs. The plans are pure
functions of the shape and of what the card reports (SM count, CTAs an SM
holds, shared memory a CTA may use), so they are checked here without a
card, at every ResNet-50 batch-norm shape at 32 images a card and at odd
ones: every row lies in exactly one chunk, the resident rows fit the
shared-memory budget, the grid fits the co-resident capacity, and the
plan depends on its arguments only. The one-launch reduction passes (the
local moments, the given-statistics backward) keep ``stats_plan``'s grid,
33 ticket counters per channel tile, and a finalize whose plain-torch
model (``tile_finalize_emulation``) sums each channel in the order of one
warp per channel, bit for bit.
"""

import numpy as np
import pytest
import torch

from paddle1_tpu_torch.core.errors import InvalidArgumentError
from paddle1_tpu_torch.ops import fused_bn as fbn
from paddle1_tpu_torch.ops import fused_bn_bwd as fbb

# (rows, C) of ResNet-50's 53 batch norms at 32 images of 224 x 224 (the
# stride on each stage's first 3 x 3 convolution), and odd shapes
RESNET50_BN = [(401408, 64), (100352, 64), (100352, 256), (100352, 128),
               (25088, 128), (25088, 512), (25088, 256), (6272, 256),
               (6272, 1024), (6272, 512), (1568, 512), (1568, 2048)]
ODD = [(98, 2048), (7, 64), (1, 8), (5, 24), (1000, 4096)]
SHAPES = RESNET50_BN + ODD
# (SMs, CTAs an SM holds, shared memory a CTA may use): an H100 SXM at
# two CTAs an SM, one CTA an SM, and a small card
CARDS = [(132, 2, 115712), (132, 1, 232448), (16, 2, 49152)]


def _rows_of(p, rows):
    """Each row's chunk under plan ``p``, row by row."""
    owner = []
    for k in range(p.chunks):
        lo = k * p.rows_per_chunk
        owner += [k] * max(0, min(rows, lo + p.rows_per_chunk) - lo)
    return owner


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("sms,blocks,budget", CARDS)
@pytest.mark.parametrize("rows,c", SHAPES)
def test_train_bwd_plan_covers_rows_and_fits_the_card(rows, c, sms, blocks,
                                                      budget, itemsize):
    p = fbb.train_bwd_plan(rows, c, itemsize, sms, blocks, budget)
    # every row lies in exactly one chunk, no chunk is empty
    owner = _rows_of(p, rows)
    assert len(owner) == rows
    assert sorted(set(owner)) == list(range(p.chunks))
    assert p.chunks * p.rows_per_chunk >= rows > (p.chunks - 1) * \
        p.rows_per_chunk
    # the block and its channel tiles cover C
    assert p.tx * 8 * p.tiles >= c > (p.tiles - 1) * p.tx * 8
    assert p.tx * p.ty <= 256 and p.tx <= 32
    # the grid fits the CTAs the card holds at once
    assert p.tiles * p.chunks <= sms * blocks and p.chunks <= 65535
    # the resident rows fit the budget and are what the budget allows
    row_bytes = 2 * p.tx * 8 * itemsize
    assert 0 <= p.resident <= p.rows_per_chunk
    assert p.smem_bytes == fbb.FIXED_SMEM + p.resident * row_bytes
    assert p.smem_bytes <= budget
    assert p.resident == p.rows_per_chunk or \
        p.smem_bytes + row_bytes > budget
    # a pure function of its arguments
    assert fbb.train_bwd_plan(rows, c, itemsize, sms, blocks, budget) == p


def test_train_bwd_plan_holds_resnet50_layers_3_and_4_whole_on_an_h100():
    """At 32 images the chunks of layers 3 and 4 fit in shared memory, so
    x and dy cross device memory once; the stem's do not."""
    h100 = CARDS[0]
    for rows, c in [(6272, 1024), (6272, 256), (1568, 2048), (1568, 512)]:
        p = fbb.train_bwd_plan(rows, c, 2, *h100)
        assert p.resident == p.rows_per_chunk, (rows, c, p)
    stem = fbb.train_bwd_plan(401408, 64, 2, *h100)
    assert 0 < stem.resident < stem.rows_per_chunk


def test_train_bwd_plan_refuses_a_row_of_tiles_wider_than_the_card():
    with pytest.raises(InvalidArgumentError, match="contract"):
        fbb.train_bwd_plan(64, 8 * 32 * 33, 2, 16, 2, 49152)


@pytest.mark.parametrize("sms,blocks,_budget", CARDS)
@pytest.mark.parametrize("rows,c", SHAPES)
def test_norm_plan_is_one_wave(rows, c, sms, blocks, _budget):
    tx, grid_y = fbn.norm_plan(rows, c, sms, blocks)
    _, ty, tiles = fbn.block_width(c)
    assert tx == min(c // 8, 32) and tx * ty <= 256
    # one wave: no more CTAs than the card holds at once (one row of
    # tiles at least), no more row blocks than the rows need
    assert tiles * grid_y <= max(tiles, sms * blocks)
    assert 1 <= grid_y <= -(-rows // ty)
    # the CTAs' row stride covers every row
    assert grid_y * ty * ((rows + grid_y * ty - 1) // (grid_y * ty)) >= rows
    assert fbn.norm_plan(rows, c, sms, blocks) == (tx, grid_y)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("sms,blocks,budget", CARDS)
@pytest.mark.parametrize("rows,c", SHAPES)
def test_train_fwd_plan_covers_rows_and_fits_the_card(rows, c, sms, blocks,
                                                      budget, itemsize):
    p = fbn.train_fwd_plan(rows, c, itemsize, sms, blocks, budget)
    owner = _rows_of(p, rows)
    assert len(owner) == rows
    assert sorted(set(owner)) == list(range(p.chunks))
    assert p.chunks * p.rows_per_chunk >= rows > (p.chunks - 1) * \
        p.rows_per_chunk
    assert p.tx * 8 * p.tiles >= c > (p.tiles - 1) * p.tx * 8
    assert p.tx * p.ty <= 256 and p.tx <= 32
    assert p.tiles * p.chunks <= sms * blocks and p.chunks <= 65535
    # one row tile of x a resident row
    row_bytes = p.tx * 8 * itemsize
    assert 0 <= p.resident <= p.rows_per_chunk
    assert p.smem_bytes == fbn.FWD_FIXED_SMEM + p.resident * row_bytes
    assert p.smem_bytes <= budget
    assert p.resident == p.rows_per_chunk or \
        p.smem_bytes + row_bytes > budget
    assert fbn.train_fwd_plan(rows, c, itemsize, sms, blocks, budget) == p
    # its partial rows are the statistics pass's chunks: whole sub-chunks a
    # CTA, every one summed once
    tx, sub_chunks, sub_rows = fbn.stats_plan(rows, c, sms)
    assert (p.tx, p.sub_rows, p.sub_chunks) == (tx, sub_rows, sub_chunks)
    assert p.rows_per_chunk % p.sub_rows == 0
    subs = p.rows_per_chunk // p.sub_rows
    assert (p.chunks - 1) * subs < p.sub_chunks <= p.chunks * subs


def test_train_fwd_plan_holds_resnet50_layers_2_to_4_whole_on_an_h100():
    """At 32 images in bf16 every chunk of layers 2-4 fits in shared
    memory, so x crosses device memory once; the stem's and layer 1's
    widest (C = 256 at 56 x 56) about half."""
    h100 = CARDS[0]
    for rows, c in [(100352, 128), (25088, 128), (25088, 512),
                    (25088, 256), (6272, 256), (6272, 1024), (6272, 512),
                    (1568, 512), (1568, 2048)]:
        p = fbn.train_fwd_plan(rows, c, 2, *h100)
        assert p.resident == p.rows_per_chunk, (rows, c, p)
    for rows, c in [(401408, 64), (100352, 256)]:
        p = fbn.train_fwd_plan(rows, c, 2, *h100)
        assert 0.4 < p.resident / p.rows_per_chunk < 0.6, (rows, c, p)


def test_train_fwd_plan_refuses_a_row_of_tiles_wider_than_the_card():
    with pytest.raises(InvalidArgumentError, match="contract"):
        fbn.train_fwd_plan(64, 8 * 32 * 33, 2, 16, 2, 49152)


def test_resnet50_bn_shapes_of_the_profile_tool():
    """The step's 53 batch norms that the profile tool's per-step bound
    sums over: 355.6 M elements at 32 images, at the shapes above."""
    from tools import torch_train_profile as tp
    shapes = tp.resnet50_bn_shapes(32)
    assert len(shapes) == 53 and shapes[0] == (401408, 64)
    assert set(shapes) == set(RESNET50_BN)
    assert sum(r * c for r, c in shapes) == 355647488
    bound = tp.bn_bound_ms_per_step(32)
    assert bound["train_fwd"] == pytest.approx(
        1e3 * 2 * 2 * 355647488 / 3.35e12)


# stats_plan (tx, chunks, rows_per_chunk) of the one-launch reduction
# passes (local moments, given-statistics backward) at every shape above on
# a 132-SM H100 and a 16-SM card: the training forward sums in these
# chunks to keep the moments' bits, so the plan must not move
STATS_PLAN = {
    132: [(8, 528, 761), (8, 526, 191), (32, 526, 191), (16, 526, 191),
          (16, 523, 48), (32, 262, 96), (32, 523, 48), (32, 523, 12),
          (32, 131, 48), (32, 262, 24), (32, 196, 8), (32, 66, 24),
          (32, 13, 8), (8, 1, 7), (1, 1, 1), (3, 1, 5), (32, 33, 31)],
    16: [(8, 64, 6272), (8, 64, 1568), (32, 64, 1568), (16, 64, 1568),
         (16, 64, 392), (32, 32, 784), (32, 64, 392), (32, 64, 98),
         (32, 16, 392), (32, 32, 196), (32, 32, 49), (32, 8, 196),
         (32, 8, 13), (8, 1, 7), (1, 1, 1), (3, 1, 5), (32, 4, 250)]}


@pytest.mark.parametrize("sms", sorted(STATS_PLAN))
@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_stats_plan_is_unchanged(sms, i):
    rows, c = SHAPES[i]
    assert fbn.stats_plan(rows, c, sms) == STATS_PLAN[sms][i]


@pytest.mark.parametrize("sms,_blocks,_budget", CARDS)
@pytest.mark.parametrize("rows,c", SHAPES)
def test_tile_counters_cover_the_reduction_grid(rows, c, sms, _blocks,
                                                _budget):
    """33 int32 counters per channel tile of the grid (tiles, chunks),
    zeroed, kept across calls: one per lane class of chunks (k mod 32),
    counting that class's CTAs in, and one counting the classes in."""
    tx, chunks, rpc = fbn.stats_plan(rows, c, sms)
    _, _, tiles = fbn.block_width(c)
    assert tx * 8 * tiles >= c > (tiles - 1) * tx * 8
    assert 1 <= chunks <= 65535 and (chunks - 1) * rpc < rows <= \
        chunks * rpc
    cpu = torch.device("cpu")
    t = fbn.tile_counters(cpu, tiles)
    assert t.dtype == torch.int32 and tuple(t.shape) == (tiles * 33,)
    assert fbn.COUNTERS_PER_TILE == 33
    # the tickets each counter expects: every chunk in one class, every
    # class with a chunk in the tile's count
    per_class = [(chunks - 1 - k) // 32 + 1 for k in range(min(chunks, 32))]
    assert sum(per_class) == chunks
    assert per_class == [len(range(k, chunks, 32))
                         for k in range(min(chunks, 32))]
    assert int(t.abs().sum()) == 0
    assert fbn.tile_counters(cpu, tiles) is t


def _one_warp_a_channel(part):
    """The reduction the kernels' finalize has always had, written out
    for one channel at a time with numpy f32 scalars: lane l sums rows l,
    l + 32, ... in turn from 0; then s_l += s_(l xor o) for o = 16, 8, 4,
    2, 1 (every lane at once); lane 0's value."""
    chunks, c = part.shape
    out = np.zeros(c, np.float32)
    for ch in range(c):
        lane = [np.float32(0.0)] * 32
        for l in range(32):
            for k in range(l, chunks, 32):
                lane[l] = np.float32(lane[l] + part[k, ch])
        for o in (16, 8, 4, 2, 1):
            lane = [np.float32(lane[l] + lane[l ^ o]) for l in range(32)]
        out[ch] = lane[0]
    return out


@pytest.mark.parametrize("chunks", [528, 1, 31, 32, 33])
def test_tile_finalize_keeps_the_order_of_one_warp_a_channel(chunks):
    """The in-launch finalize folds each lane class in the CTA that
    finishes it and runs the tree 8 channels a warp; each channel's sum
    must still be the one-warp-a-channel order, bit for bit (the training
    forward repeats it: the f32 ResNet-50 check turns on its last
    bits)."""
    rng = np.random.default_rng(chunks)
    # wide magnitudes and signs, so another order would change the bits
    part = (rng.standard_normal((chunks, 64)) *
            10.0 ** rng.integers(-3, 4, (chunks, 64))).astype(np.float32)
    got = fbn.tile_finalize_emulation(torch.from_numpy(part))
    want = torch.from_numpy(_one_warp_a_channel(part))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    # and another order does differ at 528 chunks: the check has teeth
    if chunks == 528:
        assert not torch.equal(torch.from_numpy(part).sum(dim=0), want)


@pytest.mark.parametrize("sms,blocks,_budget", CARDS)
@pytest.mark.parametrize("rows,c", SHAPES)
def test_norm_bwd_plan_is_stats_plan_cut_to_one_wave(rows, c, sms, blocks,
                                                     _budget):
    tx, chunks, rpc = fbb.norm_bwd_plan(rows, c, sms, blocks)
    s_tx, s_chunks, s_rpc = fbn.stats_plan(rows, c, sms)
    _, _, tiles = fbn.block_width(c)
    # the stats plan's block; every row in exactly one chunk, none empty
    assert tx == s_tx
    assert 1 <= chunks <= 65535 and (chunks - 1) * rpc < rows <= \
        chunks * rpc
    # no more chunks than the stats plan, and one wave of co-resident CTAs
    # (one row of tiles at least); the stats plan where it fits
    assert chunks <= s_chunks
    assert tiles * chunks <= max(tiles, sms * blocks)
    if tiles * s_chunks <= sms * blocks:
        assert (chunks, rpc) == (s_chunks, s_rpc)
    assert fbb.norm_bwd_plan(rows, c, sms, blocks) == (tx, chunks, rpc)


def test_norm_bwd_plan_at_resnet50s_stem_on_an_h100():
    """Two CTAs an SM: the stem's 528 chunks of 761 rows become 264 of
    1521, layer 4's 66 of 24 rows 33 of 48."""
    assert fbb.norm_bwd_plan(401408, 64, 132, 2) == (8, 264, 1521)
    assert fbb.norm_bwd_plan(1568, 2048, 132, 2) == (32, 33, 48)


# YOLOv3's 72 training batch norms at 8 x 608² (its 13 distinct shapes:
# C = 32-1024, 2,957,312 rows at the stem down to 2,888 at stride 32)
YOLO_TRAIN_BN = [(2957312, 32), (739328, 32), (739328, 64), (184832, 64),
                 (184832, 128), (46208, 128), (46208, 256), (11552, 128),
                 (11552, 256), (11552, 512), (2888, 256), (2888, 512),
                 (2888, 1024)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows,c", YOLO_TRAIN_BN)
def test_every_plan_takes_yolov3_training_shapes_on_an_h100(rows, c,
                                                            itemsize):
    """The cooperative training plans, forward and backward, the
    given-statistics plan and the reduction passes' plans at each shape:
    every row in one chunk, the grid co-resident, the resident rows in the
    budget, and every count the kernels keep in 32-bit ints (rows of a
    chunk, of a sub-chunk, resident rows, chunks, grid rows) inside
    int32; element offsets are 64-bit in the kernels."""
    sms, blocks, budget = CARDS[0]
    int32 = 2 ** 31
    for p in (fbn.train_fwd_plan(rows, c, itemsize, sms, blocks, budget),
              fbb.train_bwd_plan(rows, c, itemsize, sms, blocks, budget)):
        assert p.chunks * p.rows_per_chunk >= rows > \
            (p.chunks - 1) * p.rows_per_chunk
        assert p.tiles * p.chunks <= sms * blocks and p.chunks <= 65535
        assert 0 <= p.resident <= p.rows_per_chunk
        assert p.smem_bytes <= budget
        assert max(p.rows_per_chunk, p.sub_rows, p.sub_chunks,
                   p.resident * p.tx * 8) < int32
    fwd = fbn.train_fwd_plan(rows, c, itemsize, sms, blocks, budget)
    assert fwd.rows_per_chunk % fwd.sub_rows == 0
    subs = fwd.rows_per_chunk // fwd.sub_rows
    assert (fwd.chunks - 1) * subs < fwd.sub_chunks <= fwd.chunks * subs
    tx, grid_y = fbn.norm_plan(rows, c, sms, blocks)
    _, ty, tiles = fbn.block_width(c)
    assert tiles * grid_y <= max(tiles, sms * blocks) and grid_y <= 65535
    for tx_, chunks, rpc in (fbn.stats_plan(rows, c, sms),
                             fbb.norm_bwd_plan(rows, c, sms, blocks)):
        assert 1 <= chunks <= 65535 and (chunks - 1) * rpc < rows <= \
            chunks * rpc


def test_yolov3_stem_is_partly_resident_and_stride_32_whole_on_an_h100():
    """In bf16 the stem's chunks (2.96 M rows, 7.4x ResNet-50's stem) are
    only partly held in shared memory; the stride-32 shapes whole."""
    h100 = CARDS[0]
    for plan in (fbn.train_fwd_plan, fbb.train_bwd_plan):
        stem = plan(2957312, 32, 2, *h100)
        assert 0 < stem.resident < stem.rows_per_chunk, stem
        for c in (256, 512, 1024):
            p = plan(2888, c, 2, *h100)
            assert p.resident == p.rows_per_chunk, (c, p)
