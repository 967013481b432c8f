"""The stencil cost breakdown of the port against the TPU script it
replaces: the script's Pallas kernel (``make_pallas``, interpret mode) and
the port's plain version of each mode on the same numpy-seeded inputs,
the weight layout, TF32 rounding, and that nothing of the breakdown runs
without a card."""

import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pynama_tpu_torch.scripts import stencil_breakdown as sb

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / \
    "stencil_breakdown_tpu.py"
# options the script sets globally at import
JAX_OPTIONS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def script():
    """scripts/stencil_breakdown_tpu.py as a module. It reads its TR from
    sys.argv[1] and sets two JAX options when imported: give it an argv
    and set the options back afterwards."""
    saved = {k: getattr(jax.config, k) for k in JAX_OPTIONS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [str(SCRIPT), "16"])
        mp.setattr(sys, "path", list(sys.path))
        spec = importlib.util.spec_from_file_location(
            "stencil_breakdown_tpu", SCRIPT)
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        finally:
            for k, v in saved.items():
                jax.config.update(k, v)
    return mod


@pytest.mark.parametrize("mode", sb.MODES)
@pytest.mark.parametrize("B1,B2,C,TR", [
    (97, 97, 128, 16),   # the script's own shape
    (21, 13, 32, 8),     # ragged: B1 % TR, B2 % 8 != 0
], ids=lambda v: str(v))
def test_plain_matches_script_kernel(script, monkeypatch, mode, B1, B2, C,
                                     TR):
    for name, value in dict(B1=B1, B2=B2, C=C, TR=TR,
                            B2p=-(-B2 // 8) * 8).items():
        monkeypatch.setattr(script, name, value)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B1, B2, C)).astype(np.float32)
    W = rng.normal(size=(sb.F, sb.F * C, C)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        apply = script.make_pallas(mode, jax.lax.Precision.HIGHEST)
        ref = np.asarray(apply(jax.numpy.asarray(x), jax.numpy.asarray(W)))
    got = sb.breakdown_plain(
        mode, "highest", torch.as_tensor(x, dtype=torch.float64),
        sb.weights_from_script(W, device="cpu").double()).numpy()
    assert got.shape == ref.shape == (B1, B2, C)
    if mode == "fill":
        assert np.array_equal(got, ref)
    else:
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= 1e-5, err


def test_weights_from_script_layout():
    rng = np.random.default_rng(0)
    C = 5
    W = rng.normal(size=(sb.F, sb.F * C, C)).astype(np.float32)
    W4 = sb.weights_from_script(W, device="cpu")
    assert W4.shape == (sb.F, sb.F, C, C) and W4.dtype == torch.float32
    for q1 in range(sb.F):
        for q2 in range(sb.F):
            assert np.array_equal(W4[q1, q2].numpy(),
                                  W[q1, q2 * C:(q2 + 1) * C])
    with pytest.raises(ValueError):
        sb.weights_from_script(W[:, :-1], device="cpu")


@pytest.mark.parametrize("value,expected", [
    (1.0, 1.0),                              # exact in TF32
    (2.0 - 2.0**-10, 2.0 - 2.0**-10),        # largest TF32 mantissa, exact
    (-3.0 * 2.0**-20, -3.0 * 2.0**-20),      # exact, small, negative
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),        # tie: away from zero (up)
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),  # tie: away from zero (down)
    (1.0 + 2.0**-11 - 2.0**-23, 1.0),        # just below the tie
    (1.0 + 2.0**-11 + 2.0**-23, 1.0 + 2.0**-10),  # just above it
    (2.0 - 2.0**-23, 2.0),                   # largest f32 mantissa: carries
    (0.0, 0.0),
    (float("inf"), float("inf")),
])
def test_round_tf32_hand_picked(value, expected):
    for dtype in (torch.float32, torch.float64):
        got = sb.round_tf32(torch.tensor([value], dtype=dtype))
        assert got.dtype == dtype
        assert got.item() == expected, (value, dtype, got.item())
    assert torch.isnan(sb.round_tf32(torch.tensor([float("nan")]))).all()


def test_plain_default_is_plain_on_tf32_inputs():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(6, 5, 8)))
    W = torch.as_tensor(rng.normal(size=(3, 3, 8, 8)))
    for mode in ("full", "mm"):
        got = sb.breakdown_plain(mode, "default", x, W)
        ref = sb.breakdown_plain(mode, "highest", sb.round_tf32(x),
                                 sb.round_tf32(W))
        assert torch.equal(got, ref)
        assert not torch.equal(got, sb.breakdown_plain(mode, "highest", x, W))
    assert torch.equal(sb.breakdown_plain("fill", "default", x, W),
                       sb.breakdown_plain("fill", "highest", x, W))


@pytest.mark.parametrize("mode,prec", [("full", "highest"),
                                       ("fill", "highest"),
                                       ("mm", "default")])
def test_kernel_has_no_cpu_mode(mode, prec):
    x = torch.zeros(9, 9, 8)
    W = torch.zeros(3, 3, 8, 8)
    before = sb.stencil.BREAKDOWN.launches
    with pytest.raises(ValueError, match="CUDA"):
        sb.make_breakdown(mode, prec, 8)(x, W)
    assert sb.stencil.BREAKDOWN.launches == before


def test_make_breakdown_rejects_what_the_kernel_lacks():
    for args in (("full", "highest", 12), ("half", "highest", 8),
                 ("mm", "bf16", 16)):
        with pytest.raises(ValueError):
            sb.make_breakdown(*args)


def test_run_breakdown_and_cli_need_a_card(monkeypatch):
    with pytest.raises(ValueError, match="CUDA"):
        sb.run_breakdown(9, 9, 8, 8, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sb.run_breakdown(9, 9, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        sb.main(["8"])


SASS = """
\t\tFunction : _ZN45_GLOBAL__N__46b28e5c_12_stencil2d_cu_e17f296716stencil2d_kernelIfLi3ELi8ELi0ELb0EEEvPKT_S3_PS1_iiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* 0x000fe40000000800 */
        /*0010*/                   LDS R4, [R2+0x10] ;
        /*0020*/              @!P0 LDS.64 R4, [R2] ;
        /*0030*/                   FFMA R3, R4, R5, R3 ;
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
\t\tFunction : _ZN53_GLOBAL__N__d0fa8787_20_stencil_breakdown_cu_17b59cd116stencil2d_kernelIfLi3ELi16ELi2ELb1EEEvPKT_S3_PS1_iiii
        /*0000*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
\t\tFunction : other_kernel
        /*0000*/                   STS [R1], R2 ;
"""


def test_sass_counts_by_instance():
    counts = sb.sass_counts(SASS)
    assert counts == {
        "float32 F3 TH8 full highest": dict(LDS=2, STS=0, FFMA=1, HMMA=0,
                                            LDG=0, BAR=1),
        "float32 F3 TH16 mm default": dict(LDS=0, STS=0, FFMA=0, HMMA=1,
                                           LDG=0, BAR=0),
        "other_kernel": dict(LDS=0, STS=1, FFMA=0, HMMA=0, LDG=0, BAR=0)}


def test_build_tag_covers_the_headers(tmp_path):
    lib = sb.stencil.CudaLibrary("k", {})
    lib.source = tmp_path / "k.cu"
    lib.source.write_text('#include "tile.cuh"\n')
    (tmp_path / "tile.cuh").write_text("// one\n")
    before = lib._so()
    (tmp_path / "tile.cuh").write_text("// two\n")
    assert lib._so() != before and lib._so().name.startswith("libk-")


# ----------------------------------------------------------------------
# the redesigned breakdown: its tile table, names and build

@pytest.mark.parametrize("shape", [(97, 97, 128), (25, 25, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tr8_highest_is_plan2d(shape):
    C = shape[-1]
    plan = sb.breakdown_plan("highest", 8, shape)
    ref = sb.stencil.plan2d(shape, (3, 3, C, C), torch.float32)
    assert (plan.instance, plan.split, plan.vec) == (ref.instance, ref.split,
                                                     ref.vec)
    assert plan == ref
    assert sb.INSTANCES[plan.instance][2:] == \
        sb.stencil.INSTANCES2D[ref.instance][1:]


@pytest.mark.parametrize("shape", [(97, 97, 128), (25, 25, 128), (40, 37, 8),
                                   (10, 7, 70)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tr_table_tiles(shape):
    C = shape[-1]
    p8 = sb.breakdown_plan("highest", 8, shape)
    p16 = sb.breakdown_plan("highest", 16, shape)
    # TR 16: the same tile with twice the positions
    assert p16.instance == p8.instance + 2
    assert (p16.bm, p16.bn, p16.bk) == (2 * p8.bm, p8.bn, p8.bk)
    assert sb.INSTANCES[p16.instance][4:] == sb.INSTANCES[p8.instance][4:]
    assert p16.split == sb.stencil.split_k(p16.m_tiles * p16.n_tiles,
                                           p16.chunks,
                                           sb.FILL16[p16.instance])
    for TR, ieee, inst in ((8, p8, 4), (16, p16, 5)):
        tf32 = sb.breakdown_plan("default", TR, shape)
        prec, tr, bm, bn, wm, n, bk, _ = sb.INSTANCES[inst]
        assert (tf32.instance, prec, tr) == (inst, "default", TR)
        # TR 8: two m64 tiles, one a warpgroup; TR 16 twice the positions
        assert bm == TR * 16 and bm == 2 * wm and bn == n == 64 and bk == 32
        assert tf32.chunks == 9 * -(-C // 32)
        assert tf32.split == min(ieee.split, tf32.chunks)
        assert tf32.vec == (C % 4 == 0)
    with pytest.raises(ValueError):
        sb.breakdown_plan("bf16", 8, shape)
    with pytest.raises(ValueError):
        sb.breakdown_plan("highest", 12, shape)


def test_make_breakdown_rejects_an_unknown_design():
    for design in ("igemm2", None, "V1"):
        with pytest.raises(ValueError, match="design"):
            sb.make_breakdown("full", "highest", 8, design)
    for design in sb.DESIGNS:
        assert callable(sb.make_breakdown("mm", "default", 16, design))


@pytest.mark.parametrize("design", sb.DESIGNS)
def test_both_designs_have_no_cpu_mode(design):
    x = torch.zeros(9, 9, 8)
    W = torch.zeros(3, 3, 8, 8)
    before = sb.stencil.BREAKDOWN.launches
    for mode, prec in (("full", "default"), ("fill", "highest")):
        with pytest.raises(ValueError, match="CUDA"):
            sb.make_breakdown(mode, prec, 16, design)(x, W)
    with pytest.raises(ValueError, match="CUDA"):
        sb.prepare_weights(W, 4)
    assert sb.stencil.BREAKDOWN.launches == before


BREAKDOWN_SASS = """
\t\tFunction : _ZN14breakdown_gemm15breakdown_igemmILi128ELi64ELi8ELi8ELi16ELi4ELb1ELi0EEEvPKfS2_Pfiiiii
        /*0000*/                   LDS.128 R4, [R2+0x10] ;
        /*0010*/                   LDS R4, [R2] ;
        /*0020*/                   FFMA R3, R4, R5, R3 ;
        /*0030*/              @!P0 LDGSTS.E.BYPASS.128 [R1], desc[UR4][R2.64] ;
\t\tFunction : _ZN14breakdown_gemm15breakdown_wgmmaILi256ELi64ELi128ELi32ELi4ELb0ELi2EEEvPKfS2_Pfiiiii
        /*0000*/                   HGMMA.64x64x8.F32.TF32 R24, gdesc[UR4], R24 ;
        /*0010*/                   STS.128 [R1], R4 ;
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
\t\tFunction : _ZN14breakdown_gemm10prepare_wtEPKfPfiiii
        /*0000*/                   STG.E [R2.64], R5 ;
\t\tFunction : _ZN14breakdown_gemm13reduce_splitsIfEEvPKT_PS1_im
        /*0000*/                   LDG.E R5, [R2.64] ;
"""


def test_instance_name_names_the_breakdown_kernels():
    counts = sb.sass_counts(BREAKDOWN_SASS, sb.SASS_OPS_BREAKDOWN)
    zero = dict.fromkeys(sb.SASS_OPS_BREAKDOWN, 0)
    assert counts == {
        "breakdown highest BM128 BN64 TM8 TN8 BK16 S4 vec full":
            {**zero, "LDS": 2, "LDS.128": 1, "FFMA": 1, "LDGSTS": 1},
        "breakdown default BM256 BN64 WM128 BK32 S4 scalar mm":
            {**zero, "HGMMA": 1, "STS": 1, "BAR": 1},
        "breakdown prepare_wt float32": zero,
        "reduce_splits float32": zero}


def test_build_tag_covers_every_included_header(tmp_path):
    import re
    import shutil

    csrc = Path(sb.stencil.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "stencil_breakdown.cu").read_text()
    headers = re.findall(r'#include "([^"]+)"', src)
    assert "stencil2d_tile.cuh" in headers
    for h in headers:
        shutil.copy(csrc / h, tmp_path / h)
    lib = sb.stencil.CudaLibrary("stencil_breakdown", {})
    lib.source = tmp_path / "stencil_breakdown.cu"
    lib.source.write_text(src)
    tags = {lib._so()}
    for h in headers:
        (tmp_path / h).write_text((csrc / h).read_text() + "// edited\n")
        tags.add(lib._so())
    assert len(tags) == len(headers) + 1
