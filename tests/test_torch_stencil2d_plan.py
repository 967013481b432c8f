"""The host side of the 2D stencil kernel: plan2d picks, for every shape
the 384x384 cavity gives the kernel and every shape the card-only tests
launch, an instance of the shape's dtype whose tiles cover every position
and channel and whose K splits cover the F^2 Cin reduction exactly once;
it raises outside the kernel's contract. No device, no JAX."""

import math

import pytest
import torch

from pynama_tpu_torch.ops import stencil

C = 128
F32, F64 = torch.float32, torch.float64
FINE = ((97, 97, C), (3, 3, C, C))
# multigrid levels 1-3 and the coarsest K of the 384x384 cavity
COARSE = [((b, b, C), (3, 3, C, C)) for b in (49, 25, 13, 4)]
# PERF.md's 2D shape table (the cavity) and tests/test_torch_cuda.py's 2D
# shapes
SHAPES = [
    FINE, *COARSE,
    ((97, 97, C), (3, 3, C, 192)),
    ((97, 97, 192), (3, 3, 192, C)),
    ((97, 97, 64), (3, 3, 64, C)),
    ((97, 97, C), (3, 3, C, 64)),
    *[((b, b, 8), (5, 5, 8, 8)) for b in (385, 193, 97, 49, 25, 13)],
    ((21, 13, 64), (3, 3, 64, 64)),
    ((17, 9, 64), (5, 5, 64, 64)),
    ((33, 11, 64), (3, 3, 64, C)),
    ((13, 13, C), (3, 3, C, 192)),
    ((40, 37, 8), (5, 5, 8, 8)),
    ((10, 7, 70), (3, 3, 70, 70)),
]


def split_ranges(chunks, split):
    """The chunk range of each split, as the kernel computes it."""
    return [(chunks * z // split, chunks * (z + 1) // split)
            for z in range(split)]


def test_every_plan_covers_its_shape_once():
    for xs, ws in SHAPES:
        F, c_in, c_out = ws[0], ws[2], ws[3]
        M = math.prod(xs[:2])
        for dtype in (F32, F64):
            p = stencil.plan2d(xs, ws, dtype)
            spec = stencil.INSTANCES2D[p.instance]
            assert spec[0] == dtype and (p.bm, p.bn, p.bk) == (
                spec[1], spec[2], spec[5])
            # tiles cover every position and output channel, none idle
            assert (p.m_tiles - 1) * p.bm < M <= p.m_tiles * p.bm
            assert (p.n_tiles - 1) * p.bn < c_out <= p.n_tiles * p.bn
            # K: every tap's Cin channels in chunks of bk, each chunk in
            # exactly one split, every split non-empty
            per_tap = -(-c_in // p.bk)
            assert p.chunks == F**2 * per_tap
            assert (per_tap - 1) * p.bk < c_in <= per_tap * p.bk
            ranges = split_ranges(p.chunks, p.split)
            assert ranges[0][0] == 0 and ranges[-1][1] == p.chunks
            assert all(a < b for a, b in ranges)
            assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))
            assert 1 <= p.split <= stencil.MAX_SPLIT
            v = 16 // dtype.itemsize
            assert p.vec == (c_in % v == 0 and c_out % v == 0)
            # the card gets two blocks per SM wherever the K chunks allow
            if p.split < min(p.chunks, stencil.MAX_SPLIT):
                assert p.blocks >= 2 * stencil.SMS


def test_coarse_levels_split_and_the_fine_level_fills_the_card():
    for dtype in (F32, F64):
        p = stencil.plan2d(*FINE, dtype)
        assert p.blocks >= 2 * stencil.SMS and p.useful_positions >= 0.9, p
    # the coarse levels split K over blocks instead of idling the card
    for xs, ws in COARSE:
        p = stencil.plan2d(xs, ws, F32)
        assert p.split > 1 and p.blocks >= min(
            stencil.SMS, p.m_tiles * p.n_tiles * stencil.MAX_SPLIT), p
    # 8 channels take the 8-wide tile, all of its lanes busy
    for b in (385, 13):
        p = stencil.plan2d((b, b, 8), (5, 5, 8, 8), F32)
        assert (p.instance, p.bn, p.n_tiles) == (1, 8, 1), p
        assert p.blocks >= 2 * stencil.SMS or p.split == p.chunks, p


def test_forced_choices_and_purity():
    xs, ws = (21, 13, 64), (3, 3, 64, 64)
    assert stencil.plan2d(xs, ws, F32) == stencil.plan2d(list(xs), list(ws),
                                                         F32)
    assert stencil.plan2d(xs, ws, F32) == stencil.KERNEL.plan(xs, ws, F32)
    p = stencil.plan2d(xs, ws, F32, instance=1, split=5)
    assert (p.instance, p.split, p.bn, p.n_tiles) == (1, 5, 8, 8)
    assert stencil.split_k(1000, 100, 2) == 1
    assert stencil.split_k(1, 10, 2) == 10
    # the fine K apply's 148 tiles on 132 SMs: splits 2 and 3 leave the
    # busiest SM 3 blocks against a mean of 2.2 and 4 against 3.4; split
    # 4 puts 5 against 4.5, within BALANCE
    assert stencil.split_k(148, 72, 2) == 4


@pytest.mark.parametrize("xs,ws,dtype,kw,exc", [
    ((21, 13, 64), (7, 7, 64, 64), F32, {}, ValueError),         # F = 7
    ((21, 13, 64), (3, 5, 64, 64), F32, {}, ValueError),         # footprint
    ((21, 13, 64), (3, 3, 32, 64), F32, {}, ValueError),         # Cin
    ((21, 13, 9, 64), (3, 3, 64, 64), F32, {}, ValueError),      # 3D x
    ((21, 0, 64), (3, 3, 64, 64), F32, {}, ValueError),          # empty
    ((21, 13, 64), (3, 3, 64, 64), torch.float16, {}, TypeError),
    ((21, 13, 64), (3, 3, 64, 64), F64, {"instance": 1}, ValueError),
    ((21, 13, 64), (3, 3, 64, 64), F32, {"split": 65}, ValueError),
    ((65536, 32768, 8), (3, 3, 8, 8), F32, {}, ValueError),
], ids=["F7", "footprint", "cin", "3d-x", "empty", "float16",
        "f64-instance", "split", "int32"])
def test_outside_the_contract_raises(xs, ws, dtype, kw, exc):
    with pytest.raises(exc):
        stencil.plan2d(xs, ws, dtype, **kw)
