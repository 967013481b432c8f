"""The host side of the 3D stencil kernel: plan3d picks, for every shape
channel3d gives the kernel and every shape the card-only tests launch,
an instance of the shape's dtype whose tiles cover every position and
channel and whose K splits cover the F^3 Cin reduction exactly once; it
raises outside the kernel's contract. No device, no JAX."""

import math

import pytest
import torch

from pynama_tpu_torch.ops import stencil

C = 192
F32, F64 = torch.float32, torch.float64
# PERF.md's 3D shape table (channel3d) and tests/test_torch_cuda.py's
# test_kernel3d_matches_plain shapes
SHAPES = [
    ((41, 17, 17, C), (3, 3, 3, C, C)),
    ((21, 9, 9, C), (3, 3, 3, C, C)),
    ((41, 17, 17, C), (3, 3, 3, C, 2 * C)),
    ((41, 17, 17, 2 * C), (3, 3, 3, 2 * C, C)),
    ((11, 5, 5, C), (3, 3, 3, C, C)),
    ((6, 3, 3, C), (3, 3, 3, C, C)),
    ((81, 33, 33, 24), (5, 5, 5, 24, 24)),
    ((41, 17, 17, 24), (5, 5, 5, 24, 24)),
    ((21, 9, 9, 24), (5, 5, 5, 24, 24)),
    ((11, 5, 5, 24), (5, 5, 5, 24, 24)),
    ((6, 3, 3, 24), (5, 5, 5, 24, 24)),
    ((6, 3, 3, 24), (3, 3, 3, 24, 24)),
    ((7, 5, 9, 64), (3, 3, 3, 64, 64)),
    ((6, 4, 11, 64), (3, 3, 3, 64, 128)),
    ((11, 5, 5, C), (3, 3, 3, C, 2 * C)),
    ((5, 6, 3, 10), (3, 3, 3, 10, 70)),
    ((11, 5, 5, 2 * C), (3, 3, 3, 2 * C, C)),
]


def split_ranges(chunks, split):
    """The chunk range of each split, as the kernel computes it."""
    return [(chunks * z // split, chunks * (z + 1) // split)
            for z in range(split)]


def test_every_plan_covers_its_shape_once():
    for xs, ws in SHAPES:
        F, c_in, c_out = ws[0], ws[3], ws[4]
        M = math.prod(xs[:3])
        for dtype in (F32, F64):
            p = stencil.plan3d(xs, ws, dtype)
            spec = stencil.INSTANCES3D[p.instance]
            assert spec[0] == dtype and (p.bm, p.bn, p.bk) == (
                spec[1], spec[2], spec[5])
            # tiles cover every position and output channel, none idle
            assert (p.m_tiles - 1) * p.bm < M <= p.m_tiles * p.bm
            assert (p.n_tiles - 1) * p.bn < c_out <= p.n_tiles * p.bn
            # K: every tap's Cin channels in chunks of bk, each chunk in
            # exactly one split, every split non-empty
            per_tap = -(-c_in // p.bk)
            assert p.chunks == F**3 * per_tap
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


def test_fine_level_tiles_are_nearly_all_real_positions():
    for dtype in (F32, F64):
        p = stencil.plan3d((41, 17, 17, C), (3, 3, 3, C, C), dtype)
        assert p.useful_positions >= 0.9, p
        assert p.blocks >= 2 * stencil.SMS
    # the coarse levels split K over blocks instead of idling the card
    for xs in ((11, 5, 5, C), (6, 3, 3, C)):
        p = stencil.plan3d(xs, (3, 3, 3, C, C), F32)
        assert p.split > 1 and p.blocks >= stencil.SMS, p
    # 24 channels take the 24-wide tile
    p = stencil.plan3d((81, 33, 33, 24), (5, 5, 5, 24, 24), F32)
    assert p.bn == 24 and p.n_tiles == 1


def test_forced_choices_and_purity():
    xs, ws = (7, 5, 9, 64), (3, 3, 3, 64, 64)
    assert stencil.plan3d(xs, ws, F32) == stencil.plan3d(list(xs), list(ws),
                                                         F32)
    p = stencil.plan3d(xs, ws, F32, instance=1, split=5)
    assert (p.instance, p.split, p.bn) == (1, 5, 24)
    assert stencil.split3d(1000, 100, 2) == 1
    assert stencil.split3d(1, 10, 2) == 10
    # 279 tiles on 132 SMs: 3, 5 and 7 blocks on the busiest SM against
    # means of 2.1, 4.2 and 6.3; the first within BALANCE is split 3
    assert stencil.split3d(279, 324, 2) == 3


@pytest.mark.parametrize("xs,ws,dtype,kw,exc", [
    ((7, 5, 9, 64), (7, 7, 7, 64, 64), F32, {}, ValueError),     # F = 7
    ((7, 5, 9, 64), (3, 3, 5, 64, 64), F32, {}, ValueError),     # footprint
    ((7, 5, 9, 64), (3, 3, 3, 32, 64), F32, {}, ValueError),     # Cin
    ((7, 5, 64), (3, 3, 3, 64, 64), F32, {}, ValueError),        # 2D x
    ((7, 5, 0, 64), (3, 3, 3, 64, 64), F32, {}, ValueError),     # empty
    ((7, 5, 9, 64), (3, 3, 3, 64, 64), torch.float16, {}, TypeError),
    ((7, 5, 9, 64), (3, 3, 3, 64, 64), F32, {"instance": 2}, ValueError),
    ((7, 5, 9, 64), (3, 3, 3, 64, 64), F64, {"instance": 0}, ValueError),
    ((7, 5, 9, 64), (3, 3, 3, 64, 64), F32, {"instance": 9}, ValueError),
    ((7, 5, 9, 64), (3, 3, 3, 64, 64), F32, {"split": 0}, ValueError),
    ((7, 5, 9, 64), (3, 3, 3, 64, 64), F32, {"split": 65}, ValueError),
    ((2, 2, 2, 8), (3, 3, 3, 8, 8), F32, {"split": 28}, ValueError),
    ((2048, 1024, 1024, 8), (3, 3, 3, 8, 8), F32, {}, ValueError),
])
def test_outside_the_contract_raises(xs, ws, dtype, kw, exc):
    with pytest.raises(exc):
        stencil.plan3d(xs, ws, dtype, **kw)
