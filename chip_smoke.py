#!/usr/bin/env python3
"""Drive pynama_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile]

Phases, each timed; any failure exits non-zero:

1. the card: name and power limit (nvidia-smi), full-float32 matmuls;
2. the build of the three CUDA libraries (csrc/stencil2d.cu,
   csrc/stencil3d.cu, csrc/stencil_breakdown.cu), one nvcc each, started
   together;
3. 2D main path: CavityProblem(cfg).setup().run(max_steps=3) at 384x384
   Q2 elements (1,182,722 velocity dofs), float32, multigrid-CG KLE, with
   the kernels' launch counts reset just before and read just after;
4. 3D main path: UniformFlowProblem(cfg).setup().run(max_steps=3) on
   channel3d (configs/channel3d.yaml: 32x32x80 Q2 hexes, 2,040,675
   velocity dofs) with bench.py's channel3d protocol, counts reset just
   before and read just after;
5. each kernel (5a stencil2d, 5b stencil3d) against its plain PyTorch
   version at every shape the wrapper logged in phases 3 and 4 (float32,
   plus the busiest shape in float64), with its time (taken twice, first
   and last), the plain version's, F.conv2d's / F.conv3d's (cuDNN, TF32
   off: a yardstick the port never calls), the card's bound and its
   first design's time (``KERNEL.v1`` / ``KERNEL3D.v1``, ``v1_ms``), both
   again as device time (the calls captured in a CUDA graph,
   ``graph_ms`` / ``v1_graph_ms``: the new kernel may not take longer
   than the first design at any shape) and the plan (plan2d / plan3d);
   then each instance's registers (ptxas) and static SASS counts (shared
   loads, 16-byte ones, FMAs per K chunk), and four launches on the same
   inputs that must agree bit for bit, at the busiest fine shape and at
   the most-split coarse one;
6. a 16x16 cavity run twice on the card, through the kernel and with the
   plain version forced, whose vorticities must agree;
7. the 3D Taylor-Green case (CustomFuncProblem) on 8x8x8 Q2 hexes, 3
   steps, through the kernel and with the plain version forced: the
   vorticities must agree and the velocity must match the exact field;
8. only with --profile: each main path again, its step 3 under
   torch.profiler. The device busy share is the summed device time of
   that step's kernels over the wall time of step 3 in phase 3 or 4,
   which ran the same work (same stencil launches and CG iterations,
   checked) without the profiler;
9. the stencil cost breakdown (pynama_tpu_torch/scripts/stencil_breakdown.py,
   its own path, not the main path's): at 97x97x128 (the fine K apply)
   and 25x25x128 (MG level 2), tile rows 8 and 16, both designs (the
   implicit GEMM that production runs, and the first one, v1) in every
   mode and precision against the plain version (fill exactly, IEEE
   float32 to 1e-5, TF32 to 1e-4 of the plain version on TF32-rounded
   inputs); full/highest at tile rows 8 must equal stencil.conv_blocked
   bit for bit (the breakdown runs production's instance and plan); then
   every row of run_breakdown and both cuDNN yardsticks (TF32 off and
   on) timed with the launch counts reset just before: full/highest at
   tile rows 8 must time within 25% of the production row, and no full
   or mm row of the new design may be slower than its [v1] row;
10. the parity leg (float64 state refined by kle.solve_ir to a true
   relative residual of 1e-8, float32 multigrid-CG inner solves;
   bench.py's parity settings):
   10a CavityProblem(cfg).setup().run(max_steps=2) at 384x384 in
       float64 under kle-refine, counts reset just before and read just
       after; stencil2d's float64 launches and its float32 ones must
       each be > 0; cut from 3 steps to PARITY_STEPS (2) to make room
       for phase 16 (a parity step takes 17.5-20.5 s);
   10b the true float64 relative residual of solve_ir on the final mask
       at the initial vorticity and after 10a's last step, formed anew
       (<= 1e-8);
   10c a 16x16 refined cavity through the kernel and with the plain
       version forced (vorticities within 1e-6);
   10d one refined solve_kle of the 8x8x8 3D Taylor-Green case
       (stencil3d's float64 and float32 instances): true residual
       <= 1e-8, velocity within 0.15 of the exact field;
   10e stencil2d against its plain version at every shape 10a logged,
       timed as device time beside cuDNN's, and 10a's launches and
       time by instance;
11. the ws legs: bench.py's float32 cavity and channel3d legs run with
   kle-ws-extrapolate on (each RK stage warm-starts its KLE solves from
   its own slot's last two accepted solutions); phases 3 and 4 stay
   ws-off, and ws changes only warm starts, so each final vorticity
   must lie within 1e-4 relative of its ws-off counterpart:
   11a CavityProblem(cfg).setup().run(max_steps=3) at 384x384 with ws
       on, counts reset just before and read just after, against
       phase 3 (step 3's CG iterations beside phase 3's);
   11b bench.py's step on 11a's problem: make_attempt_host_stepper
       around make_bs5_scan_attempt(ws_extrapolate=True), from
       make_ws_state after the initial RHS, 3 steps at cavity_config's
       dt, against 11a;
   11c UniformFlowProblem(cfg).setup().run(max_steps=3) on channel3d
       with ws on, against phase 4;
   11d a 16x16 cavity with ws on through the kernel and with the plain
       version forced (vorticities within 1e-4);
12. the immersed-boundary path (ImmersedBoundaryProblem and
   ImmersedBoundaryDynamicProblem, float64 state, stencil2d's float64
   instance through every KLE solve and its multigrid V-cycle), each
   run failing unless the vorticity is finite, the slip at the body
   max |H u - U_body| < 1e-6, the last cd > 0, and the final velocity's
   grid layout holds (the port's blocked <-> grid converters equal a
   reshape written from the layout's definition, and every boundary node
   found by the mesh's numbering holds the far field within 1e-12 u_ref;
   the slip alone cannot show a swapped layout, which the correction
   would enforce just as well):
   12a configs/ibm-static.yaml as shipped (48x48 Q2 on [-3,3]^2, Re 10,
       kle-rtol 1e-10), 3 steps through phase_main, with the flux-CG
       iterations of every post-step and stencil2d's launches by
       instance and dtype; then the same run again under torch.cuda's
       sync debug mode: host syncs per step, and whether the vorticity
       is bitwise equal to the first run's;
   12b configs/ibm-dynamic.yaml as shipped (48x48 on [-4,4]^2, Re 140),
       3 steps; the body must have moved;
   12c the Re-40 regression geometry of tests/test_ibm_physics.py
       (144x96 Q2 on [-6,12]x[-6,6], 55,777 nodes, kle-rtol 1e-8),
       3 steps: the first non-square 2D grid (25x37 blocks);
   12d tests/test_ibm.py's ibm_config(nelem=16) through the kernel and
       with the plain version forced, 3 steps: vorticity within 1e-8,
       the same steps, t within 1e-9 (the adaptive dt follows wlte, as
       wlte^(-1/5)), the last cd within 1e-6;
   12f 12c's configuration under kle-refine (float64 state, true
       float64 residuals, float32 V-cycles through kle.solve_ir),
       IBM_REFINE_STEPS (3) steps: the slip after every step, stencil2d
       launching both float64 and float32, every tensor of the problem on
       cuda:0, the inner system float32, refinement rounds and inner CG
       iterations per step, and the final vorticity within
       IBM_REFINE_VORT_LIMIT of 12c's (100 x the port's refined vs
       unrefined 12x12 pair on the CPU, ibm_refine_vort_cpu());
   12g the Re-100 Strouhal protocol's configuration
       (scripts/ibm_regression.py st_config(), KickedCylinder: 96x64 Q2
       on [-4,8]x[-4,4], 24,897 nodes, Re 100, kle-rtol 1e-7, under
       kle-refine), IBM_REFINE_STEPS (3) steps from the kicked vorticity:
       12f's checks (slip after every step, float64 and float32
       launches, every tensor on cuda:0, the inner system float32, one
       raw lift entry a step) and the kick on the card in float64,
       bitwise ibm_regression.kick() of the mesh's nodes;
   12e stencil2d against its plain version at every shape 12a-12c, 12f
       and 12g logged (float64 to 1e-12; the refined legs' float32
       V-cycle shapes to 1e-5), timed as device time beside cuDNN's, and four
       bitwise-equal launches at the non-square fine float64 shape and
       at the most-split float64 shape;
13. the command line: pynama_tpu_torch.run_case.main(argv) called in
   this process (the CUDA device, the default), the working directory
   and every save-dir a temporary directory, the launch counts reset
   just before each leg's first call and read just after its last; a
   line first says whether yaml, h5py and matplotlib are installed:
   13a -case cavity, configs/cavity.yaml as shipped (30x30 Q2, float64,
       7,442 velocity dofs), -max-steps 2 -opt save-n-steps=1: the
       metrics file, the step-2 checkpoint (its vorticity bit for bit
       the run's final one) and, where h5py is installed,
       vec-data-00002.h5 (the same); cut from 4 steps to keep the
       script's time as phase 15 was added;
   13b -resume from 13a's step-1 checkpoint (a copy kept when 13a saved
       it) to step 2 (until 12f was added, 13b ran step 1 again to a
       checkpoint of its own): a resumed cavity warm-starts both of its
       solves from the checkpoint's one velocity (as the reference's), so
       the final vorticity matches 13a's within CLI_RESUME_FACTOR x the
       KLE rtol, not bit for bit (whether it is bitwise is reported);
   13c full width: cavity_config(384) written as a YAML file and run
       with -config <file> -case cavity -dtype float32, -max-steps 3
       -opt save-n-steps=2, then resumed from the step-2 checkpoint to
       step 3: within WS_LIMIT (1e-4, a warm-start change) of the
       uninterrupted run, which must equal phase 3's bit for bit (the
       same computation through the library); ms per step and the
       seconds of each save (checkpoint, and XDMF where h5py is
       installed); only float32 stencil2d launches;
   13d -case ibm-static -max-steps 3 -opt save-n-steps=1, then a run to
       step 2 resumed to step 3: the metrics hold cd, cl and strouhal,
       and the resumed cd history is within IBM_CD_LIMIT (1e-6, 12d's)
       of the uninterrupted one;
   13e -case uniform -max-steps 1 -opt kle-solver=gmres
       -opt multigrid=false: GMRES's iterations recorded, and the final
       velocity within GMRES_CG_FACTOR x the KLE rtol of a CG solve of
       the same system;
   13f -case taylor-green -test kle (11 KLE solves at rtol 1e-13): each
       error within KLE_ERR_RTOL of the reference's and falling, as in
       its JSON; and -test chartkle -opt time-solver.max-steps=3;
   13g stencil2d against its plain version at every shape 13a-13f
       logged that no earlier phase checked, timed as device time
       beside cuDNN's;
14. unstructured Gmsh meshes (float64; ElementOps and additive Schwarz,
   plain torch: the path launches no stencil kernel, and every count,
   set to 0 just before each run and read just after, must stay 0); the
   meshes are Gmsh v2.2 files this script writes to a temporary
   directory from seeded jitters of interior corners:
   14a CavityProblem(cfg).setup().run(max_steps=3), configs/cavity.yaml's
       material, BCs and time-solver on 128x128 quads jittered by
       +-0.15/128 (16,384 cells, 132,098 velocity dofs; unnamed: the
       walls come from the geometric fallback); one-level vertex-star
       Schwarz (the coarse space is over its guard); setup seconds by
       stage, ms per step, attempts, CG iterations per solve, peak
       memory and whether the numbering ran natively;
   14b CustomFuncProblem(cfg, case="taylor-green") on 16^3 hexes
       jittered by +-0.03/16, 3 steps: the vertex stars exceed the block
       guard, so the Schwarz retries with element blocks; the velocity
       within GMSH_TG_EXACT_LIMIT of the exact field (the port's CPU
       run of the same config plus 5%);
   14c run_case.main(["-case", "channel3d", "-gmsh", FILE, ...]) for 1
       step: channel3d.yaml's geometry at 12x12x30 hexes with the x = 0
       quads named "left"; the named face's nodes, and the uniform flow
       reproduced (it is the exact solution: this leg checks the CLI
       path and the named 3D faces, not CG work);
   14d an 8x8 Gmsh cavity (3 steps) and a 3x3x3 Gmsh Taylor-Green (1
       step; 2 until 12g was added) on the card and on the CPU, each
       run's seconds: vorticities within 1e-8, CG lists side by side;
       14a's initial RHS (its first two solves)
       again, bit for bit with the same CG iterations, then once more
       under the sync debug mode and the profiler: host syncs, kernels
       and device time per CG iteration; and the initial RHS of 14a's
       cavity at 32x32 (64x64 until 12g was added, 14a's 128x128 until
       phase 17 was, each cut to make room) on the card and on a problem
       set up with device="cpu": RHS and velocities within 1e-8, CG
       iterations side by side;
15. immersed bodies on Gmsh domains (float64; the Gmsh path of phase 14
   with UnstructuredIBMCoupling for a static body and LatticeIBMCoupling
   for a moving one, plain torch: every launch count, set to 0 just
   before each run and read just after, must stay 0); graded meshes are
   tensor products of axes uniform at 'h-min' over a core box around
   the body and growing by at most x1.1 an element outside it
   (graded_axis), written as Gmsh v2.2 files to a temporary directory.
   Each run fails unless the coupling is the expected one, the
   vorticity finite, the slip max |H u - U_body| < 1e-6 after every
   step, the mesh's boundary nodes (its own numbering) at the far field
   within 1e-12 u_ref, the last cd finite and > 0 (and a moving body
   moved); each records setup seconds by stage and the coupling's
   build, ms per step, KLE CG iterations per solve, flux-CG iterations
   per post-step, cd and cl, and peak memory:
   15a the Re-40 geometry (ibm_re40_config(): [-6,12]x[-6,6], kle-rtol
       1e-8), core [-1.5,4.5]x[-1.5,1.5] at 'h-min' 1/8 (the 144x96
       box's width): 84x56 quads, 38,194 velocity dofs, 3 steps;
   15b configs/ibm-dynamic.yaml's geometry ([-4,4]^2, Re 140), core
       [-1.5,1.5]^2 at 'h-min' 1/6 (its 48x48 width): 38x38 quads,
       11,858 velocity dofs, 3 steps;
   15c a uniform 12x12 Gmsh box of [-3,3]^2 with ibm_small_config's
       material, static and moving, 2 steps on the card and on the CPU
       (vorticity within 1e-8, KLE and flux CG lists equal); 15a's and
       15b's first post-steps again: bitwise equal, the same iterations;
   15d configs/ibm-static.yaml's 48x48 box written as a uniform Gmsh
       file ('h-min' 6/48), 3 steps: UnstructuredIBMCoupling's windows
       equal to IBMCoupling's on 12a's mesh as node -> weight maps within
       1e-14, and the cd history within IBM_GMSH_BOX_CD_LIMIT of 12a's
       record (no second box run);
16. prime element counts, whose multigrid hierarchies take a padded
   (fictitious-domain) first jump: the fine level is extended by a
   Dirichlet-masked ghost band to the next even count, and the jump
   runs the grid-layout transfers (pad, scatter, crop) instead of the
   blocked ones; 383 and 79 admit no super-blocking factor, so every
   fine-level apply runs in the parity layout (8 channels in 2D, 24 in
   3D):
   16a CavityProblem(cfg).setup().run(max_steps=2) at 383x383 (383 ->
       192 on a 384x384 extension, then phase 3's hierarchy; 1,176,578
       velocity dofs), float32, counts reset just before and read just
       after; step 2's ms, setup seconds and CG iterations per solve
       beside phase 3's; each mask's V-cycle symmetric on seeded vectors
       within SYMMETRY_LIMIT; then stencil2d against its plain version
       at every shape 16a logged, with the bound and cuDNN's time;
   16b UniformFlowProblem(cfg).setup() and one solve_kle of a seeded
       vorticity on channel3d's geometry at 31x31x79 (32x32x80
       extension, 1,893,213 velocity dofs), float64 at the config's
       KLE rtol of 1e-8 (stencil3d's float64 instance), counts reset
       just before and read just after: the true float64 relative
       residual, formed anew, within 2 x the rtol; then stencil3d
       against its plain version at every shape 16b logged, with the
       bound and cuDNN's time;
17. distributed runs (pynama_tpu_torch/parallel/: ShardedNSProblem, the
   distributed V-cycle, run_case's -sharded N) through torch.distributed
   with NCCL, rank r on cuda:r:
   17a phase 3's configuration (cavity_config(384), float32, the dual
       mask, the distributed multigrid) through ShardedNSProblem(p, 1) in
       an NCCL group of one rank, run(max_steps=3), the launch counts
       reset just before and read just after: the final vorticity within
       SHARDED_LIMIT (1e-4) of phase 3's at the same step count (the
       owned-weight dots sum in another order, so CG may stop an
       iteration apart); ms per step (steps 2-3) beside phase 3's,
       CG iterations per solve, all-reduces, all-gathers, halo exchanges
       and stencil2d launches per CG iteration, and that every tensor of
       the ShardedNSProblem is on cuda:0;
   17b run_case.main(["-case", "cavity", "-sharded", "1", "-nelem", "32",
       "32", "-max-steps", "1", ...]) (2 steps until 17d was added): one
       spawned NCCL rank, owner.vtk and the metrics file; then -sharded
       <visible cards + 1> must exit with the reference's message;
   17c 17a's run on 2 and on 4 ranks, each only where that many cards
       are visible (one card: neither runs, and the line says so);
   17d 14a's 128x128 Gmsh cavity (f64, 132,098 velocity dofs, unstructured-pc
       jacobi) through ShardedUnstructuredProblem(p, 1) in an NCCL group
       of one rank, run(max_steps=SHARDED_UNSTRUCTURED_STEPS) at 14a's
       dt0, the launch counts reset just before the setup and read after
       the run: the run's initial RHS and both of its solves' velocities
       within GMSH_CPU_LIMIT (1e-8) of the problem's own single-device
       RHS on the same inputs and warm starts (CG iterations side by
       side); one all-reduce an elemental apply (sum of the solves' CG
       iterations + 1, plus 8 a RHS); every tensor of the wrapper on
       cuda:0, no stencil launch, a finite vorticity; setup seconds, ms
       per step, CG iterations per solve, all-reduces per CG iteration.

The last lines are a JSON line of every result, a JSON "kernels" line,
the nvidia-smi line and {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import gc
import importlib.util
import itertools
import json
import math
import os
import shutil
import sys
import tempfile
import time

# published H100 SXM peaks at 700 W (NVIDIA data sheet): float32 without
# tensor cores, float64 on the tensor cores (IEEE double, the card's
# fastest float64 rate), HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
PEAK_BYTES = 3.35e12
TOL = {"float32": 1e-5, "float64": 1e-12}
# phase 10: bench.py's parity target, a true float64 relative residual;
# 10a's steps, cut from 3 to make room for phase 16
PARITY_RTOL = 1e-8
PARITY_STEPS = 2
# phase 9: the fine K apply and MG level 2 (the 2D shape furthest behind
# cuDNN); fill is a copy, highest sums float32 in another order, default
# sums TF32 products on the tensor cores in another order
BREAKDOWN_SHAPES = ((97, 97, 128), (25, 25, 128))
BREAKDOWN_TOL = {"fill": 0.0, "highest": 1e-5, "default": 1e-4}
# full/highest at tile rows 8 against the production row: the same
# instance and plan, so only timing noise separates them
SAME_DESIGN_GAP = 0.25
# phase 11: a ws leg's final vorticity against its ws-off phase's
WS_LIMIT = 1e-4
# phase 12: the slip at the body after the correction (tests/test_ibm.py's
# bound), and 12d's kernel-vs-plain limits (vorticity, last cd)
SLIP_LIMIT = 1e-6
# the final velocity's boundary nodes against the far field, over u_ref:
# Dirichlet dofs that the KLE and the correction leave as they are
LAYOUT_LIMIT = 1e-12
IBM_PLAIN_LIMIT = 1e-8
IBM_CD_LIMIT = 1e-6
# the adaptive dt goes as wlte^(-1/5): kernel and plain runs whose states
# differ by IBM_PLAIN_LIMIT end their steps that far apart over ~5 and more
IBM_T_LIMIT = 1e-9
# 12f: the Re-40 geometry under kle-refine, as many steps as 12c, its
# final vorticity against 12c's (unrefined) within 100 x the port's refined
# vs unrefined 12x12 runs on the CPU (ibm_refine_vort_cpu())
IBM_REFINE_STEPS = 3
IBM_REFINE_VORT_CPU = 1.7742624261236585e-06
IBM_REFINE_VORT_LIMIT = 100 * IBM_REFINE_VORT_CPU
# configs/ibm-static.yaml and configs/ibm-dynamic.yaml as shipped (copied;
# tests/test_torch_ibm_dynamic.py holds the copies equal to the files)
IBM_CONFIGS = {
    "ibm-static": {
        "name": "ibm-static", "save-dir": "run-ibm-static",
        "save-n-steps": 5,
        "domain": {"ngl": 3, "box-mesh": {"nelem": [48, 48],
                                          "lower": [-3, -3],
                                          "upper": [3, 3]}},
        "boundary-conditions": {"constant": {"re": 10, "direction": 0,
                                             "longRef": "1"}},
        "bodies": [{"type": "circle", "vel": "static", "radius": 0.5,
                    "center": [0, 0]}],
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "time-solver": {"max-steps": 100, "start-time": 0, "end-time": 120,
                        "dt0": 0.01},
    },
    "ibm-dynamic": {
        "name": "ibm-dynamic", "save-dir": "run-ibm-dynamic",
        "save-n-steps": 10,
        "domain": {"ngl": 3, "box-mesh": {"nelem": [48, 48],
                                          "lower": [-4, -4],
                                          "upper": [4, 4]}},
        "bodies": [{"type": "circle", "vel": "dynamic", "radius": 0.5,
                    "center": [0, 0]}],
        "boundary-conditions": {"constant": {"re": 140, "direction": 0,
                                             "longRef": "1"}},
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "time-solver": {"max-steps": 1000, "start-time": 0, "end-time": 300,
                        "dt0": 0.005},
    },
}


# phase 16: prime element counts, whose multigrid hierarchies take a
# padded (fictitious-domain) first jump: the cavity at 383x383 (383 ->
# 192 on a 384x384 extension, phase 3's hierarchy below it) and the 3D
# channel at 31x31x79 (-> 16x16x40 on 32x32x80)
PADDED_NELEM_2D = 383
PADDED_NELEM_3D = (31, 31, 79)
PADDED_STEPS = 2
# 16a: the V-cycle's symmetry |<a, M b> - <b, M a>| <= this x |a| |M b|,
# a float32 V-cycle at 1.18 M dofs (dots in float64)
SYMMETRY_LIMIT = 1e-5
# 16b: configs/channel3d.yaml's KLE rtol; the true float64 residual,
# formed anew, within this many rtols
PADDED_3D_RTOL = 1e-8
PADDED_RESIDUAL_FACTOR = 2


# phase 13b: the resumed cavity's CG iterates differ from the
# uninterrupted run's (both solves warm-started from one velocity); each
# solve stops within the KLE rtol, and this many rtols bound what two
# resumed steps leave in the vorticity
CLI_RESUME_FACTOR = 100
# phase 13a: the shipped cavity's steps (saves every half), 13b resumes
# from the half-way checkpoint; cut from 4 to 2 when phase 15 was added
CLI_CAVITY_STEPS = 2
# phase 13e: GMRES against CG on the same system, in KLE rtols. GMRES
# stops on the Jacobi-preconditioned residual, so its velocity lies within
# cond(M A) x rtol of the system's solution: 17.2 rtols (1.72e-9) in a CPU
# run of 13e's command, where a CG solve at rtol 1e-13 sat 3.4e-10 from
# the uniform field and the GMRES one 1.65e-9
GMRES_CG_FACTOR = 100
# phase 13f: the reference's -test kle errors on configs/taylor-green.yaml
# (python -m pynama_tpu.run_case -case taylor-green -test kle, float64 on
# the CPU), one per viscous time; the port's within KLE_ERR_RTOL of each
REF_KLE_ERRORS = [
    0.031965392546448715, 0.030486371068300534, 0.026291236415390915,
    0.014542267418449885, 0.005420017061559309, 0.0013611832349359992,
    0.00023034561016683087, 2.626580401872379e-05, 2.0181287515284355e-06,
    1.0448512116815584e-07, 3.6450831735457286e-09]
KLE_ERR_RTOL = 1e-6


def cavity_config(nelem):
    """bench.py's cavity_config() (copied), with tolerances that accept
    every attempt and dt held at 5e-5 (dt0 = max-dt). bench.py steps at
    1e-3, above the explicit stability limit at 384x384 (on purpose
    there: its end state is not checked); at 1e-3 the float32 vorticity
    is no longer finite after 3 steps. The limit scales as h^2 and lies
    between 0.4 and 0.6 at 8x8 (tests/test_torch_cavity_dt_limit.py,
    tests/test_torch_cavity_setup.py), so between about 1.7e-4 and
    2.6e-4 at 384x384."""
    return {
        "multigrid": True,
        "name": "cavity-smoke",
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "domain": {
            "ngl": 3,
            "box-mesh": {"nelem": [nelem, nelem], "lower": [0, 0],
                         "upper": [1, 1]},
        },
        "time-solver": {"start-time": 0.0, "end-time": 100.0,
                        "max-steps": 10000, "dt0": 5e-5, "max-dt": 5e-5,
                        "atol": 1e12, "rtol": 1e12},
        "boundary-conditions": {"no-slip": {"up": [1.0, 0.0]}},
        "kle-rtol": 1e-5,
        "kle-maxiter": 4000,
    }


def channel3d_config():
    """configs/channel3d.yaml's geometry with bench.py's channel3d
    protocol (bench.py:503-540): KLE rtol 1e-5, at most 4000 CG
    iterations, a fixed dt of 1e-3 (dt0 = max-dt) and tolerances that
    accept every attempt, so a step is 7 RHS evaluations. bench.py runs
    it with cross-step warm-start extrapolation on; here it is off (each
    stage warm-starts from the previous stage), so phase 4 stays
    comparable with earlier runs, and phase 11c turns it on. The
    explicit limit scales as h^2 and
    lies near 0.4 at h = 1/8 with the same nu (tests/
    test_torch_cavity_dt_limit.py), about 0.017 at h = 1/32 even with the
    3D Laplacian's 3/2 factor: 17 times the 1e-3 used here."""
    return {
        "name": "channel3d-smoke",
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "domain": {
            "ngl": 3,
            "box-mesh": {"nelem": [32, 32, 80], "lower": [0, 0, 0],
                         "upper": [1, 1, 2.5]},
        },
        "time-solver": {"start-time": 0.0, "end-time": 100.0,
                        "max-steps": 10000, "dt0": 1e-3, "max-dt": 1e-3,
                        "atol": 1e12, "rtol": 1e12},
        "kle-rtol": 1e-5,
        "kle-maxiter": 4000,
    }


def parity_config(nelem):
    """bench.py's parity leg (bench.py:256-268): float64 state refined by
    kle.solve_ir to a true relative residual of 1e-8, the adaptive inner
    tolerance off, no warm-start extrapolation; cavity_config()'s dt of
    5e-5 (bench.py's 1e-3 lies above the explicit limit)."""
    return {**cavity_config(nelem), "kle-refine": True,
            "kle-rtol": PARITY_RTOL, "kle-adaptive-inner": False}


def taylor_green3d_config():
    """configs/taylor-green2d-3d.yaml's material (rho 0.5, mu 0.01) on
    8x8x8 Q2 hexes of the unit cube, the 3D Taylor-Green case, KLE rtol
    1e-5 (float32). dt is held at 0.01 (every attempt accepted) so the
    kernel and the plain run take the same steps; the explicit limit at
    h = 1/8 and nu = 0.02 is near 0.2 (tests/
    test_torch_cavity_dt_limit.py: 0.4 at nu = 0.01)."""
    return {
        "name": "taylor-green3d-smoke",
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {
            "ngl": 3,
            "box-mesh": {"nelem": [8, 8, 8], "lower": [0, 0, 0],
                         "upper": [1, 1, 1]},
        },
        "time-solver": {"start-time": 0.0, "end-time": 1.0,
                        "max-steps": 100, "dt0": 0.01, "max-dt": 0.01,
                        "atol": 1e12, "rtol": 1e12},
        "kle-rtol": 1e-5,
        "kle-maxiter": 4000,
    }


def ibm_re40_config():
    """tests/test_ibm_physics.py's _cfg() (copied; no max-dt, float64
    state, no kle-refine): the static cylinder at Re 40 on 144x96 Q2
    elements of [-6,12]x[-6,6] (55,777 nodes), rho 1, mu 0.025,
    kle-rtol 1e-8."""
    return {
        "name": "cyl-re40-regression",
        "material-properties": {"rho": 1.0, "mu": 0.025},
        "domain": {"ngl": 3, "box-mesh": {"nelem": [144, 96],
                                          "lower": [-6, -6],
                                          "upper": [12, 6]}},
        "boundary-conditions": {"constant": {"re": 40, "direction": 0,
                                             "longRef": "1"}},
        "bodies": [{"type": "circle", "vel": "static", "radius": 0.5,
                    "center": [0, 0]}],
        "time-solver": {"start-time": 0, "end-time": 40.0,
                        "max-steps": 500, "dt0": 0.01},
        "kle-rtol": 1e-8,
    }


def ibm_small_config(nelem):
    """tests/test_ibm.py's ibm_config(nelem) (copied): a static
    cylinder at Re 20 on [-3,3]^2, kle-rtol 1e-10."""
    return {
        "name": "ibm-test",
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": 3, "box-mesh": {"nelem": [nelem, nelem],
                                          "lower": [-3, -3],
                                          "upper": [3, 3]}},
        "time-solver": {"start-time": 0, "end-time": 1.0, "max-steps": 100,
                        "dt0": 0.01},
        "boundary-conditions": {"constant": {"re": 20.0, "direction": 0,
                                             "longRef": "1"}},
        "bodies": [{"type": "circle", "vel": "static", "radius": 0.5,
                    "center": [0, 0]}],
        "kle-rtol": 1e-10,
    }


def ibm_refine_vort_cpu():
    """The source of IBM_REFINE_VORT_CPU: ibm_small_config(12) at
    kle-rtol 1e-8 run IBM_REFINE_STEPS steps on the CPU with kle-refine
    on and off, the relative difference of the final vorticities (one
    torch thread, as tests/test_torch_ibm_regression.py runs it).

        python3 -c "import chip_smoke; print(chip_smoke.ibm_refine_vort_cpu())"
    """
    import torch

    from pynama_tpu_torch.cases.immersed import ImmersedBoundaryProblem

    vorts = []
    for refine in (True, False):
        cfg = {**ibm_small_config(12), "kle-rtol": 1e-8,
               "kle-refine": refine}
        p = ImmersedBoundaryProblem(cfg, device="cpu").setup()
        vort, _, n = p.run(max_steps=IBM_REFINE_STEPS)
        if n != IBM_REFINE_STEPS or p._refine != refine:
            fail(f"ibm_refine_vort_cpu: {n} steps, refine {p._refine}")
        vorts.append(vort)
    a, b = vorts
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def fail(msg):
    raise RuntimeError(msg)


def event_ms(torch, fn, reps, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _flops(xs, ws):
    return 2.0 * math.prod(xs[:-1]) * math.prod(ws)


def bound_times(xs, ws, name):
    """(seconds by operations, seconds by bytes, bytes) of one contraction
    at the card's peaks: each input read once, the output written once."""
    size = 8 if name == "float64" else 4
    nbytes = size * (math.prod(xs) + math.prod(ws)
                     + math.prod(xs[:-1]) * ws[-1])
    return _flops(xs, ws) / PEAK_FLOPS[name], nbytes / PEAK_BYTES, nbytes


def checked_inputs(torch, stencil, kern, xs, ws, name):
    """Seeded inputs of a logged shape, the plain version's result and
    the kernel's error against it; fails above TOL[name]."""
    import numpy as np

    dtype = getattr(torch, name)
    rng = np.random.default_rng(sum(xs) * 1000 + sum(ws))
    x = torch.as_tensor(rng.normal(size=xs), dtype=dtype, device="cuda")
    W = torch.as_tensor(rng.normal(size=ws), dtype=dtype, device="cuda")
    y = kern(x, W)
    ref = stencil.conv_blocked_plain(x, W)
    torch.cuda.synchronize()
    abs_err = float((y - ref).abs().max())
    rel_err = abs_err / float(ref.abs().max())
    if not rel_err <= TOL[name]:
        fail(f"{kern.name} disagrees at x {xs} W {ws} {name}: "
             f"{rel_err:.3e}")
    return x, W, ref, abs_err, rel_err


def library_call(tnf, x, W):
    """The same contraction as one cuDNN convolution (NCHW / NCDHW)."""
    dim = W.dim() - 2
    Q = (W.shape[0] - 1) // 2
    perm_x = (dim,) + tuple(range(dim))
    xn = x.permute(perm_x).unsqueeze(0).contiguous()
    wn = W.permute((dim + 1, dim) + tuple(range(dim))).contiguous()
    conv = tnf.conv2d if dim == 2 else tnf.conv3d
    back = tuple(range(1, dim + 1)) + (0,)
    return (lambda: conv(xn, wn, padding=Q)), back


def phase_kernels(torch, stencil, kern, logged, out):
    """The kernel against its plain version at every logged shape
    (float32) and at the busiest one in float64, its first design
    (``kern.v1``) timed beside it."""
    import torch.nn.functional as tnf

    from pynama_tpu_torch.scripts.stencil_sweep import graph_ms

    torch.backends.cudnn.allow_tf32 = False
    shapes = sorted(logged, key=lambda s: -logged[s] * _flops(s[0], s[1]))
    if not shapes:
        fail(f"{kern.name}: no shapes were logged on the main path")
    head = shapes[0]
    cases = [(xs, ws, "float32") for xs, ws, dt in shapes
             if dt == "float32"] + [(head[0], head[1], "float64")]
    rows = []
    v1, v1_before = kern.v1, kern.v1_launches
    for xs, ws, name in cases:
        dtype = getattr(torch, name)
        x, W, ref, abs_err, rel_err = checked_inputs(torch, stencil, kern,
                                                     xs, ws, name)
        lib_fn, back = library_call(tnf, x, W)
        lib = lib_fn()[0].permute(back)
        lib_err = float((lib - ref).abs().max()) / float(ref.abs().max())
        flops = _flops(xs, ws)
        reps = max(3, min(20, int(5e10 / flops)))
        k_ms = event_ms(torch, lambda: kern(x, W), reps)
        p_ms = event_ms(torch, lambda: stencil.conv_blocked_plain(x, W), reps)
        l_ms = event_ms(torch, lib_fn, reps)
        v1_ms = event_ms(torch, lambda: v1(x, W), reps)
        k_ms2 = event_ms(torch, lambda: kern(x, W), reps)
        t_ops, t_bytes, nbytes = bound_times(xs, ws, name)
        row = {
            "dtype": name, "x": list(xs), "W": list(ws),
            "main_path_launches": logged.get((xs, ws, name), 0),
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "library_rel_err": lib_err, "kernel_ms": k_ms,
            "kernel_ms_again": k_ms2, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        }
        p = kern.plan(xs, ws, dtype)
        row.update(v1_ms=v1_ms, plan={
            "instance": p.instance, "split": p.split, "blocks": p.blocks,
            "vec": p.vec, "useful_positions": p.useful_positions},
            graph_ms=graph_ms(lambda: kern(x, W), reps),
            v1_graph_ms=graph_ms(lambda: v1(x, W), reps))
        row["share_of_bound"] = row["bound_ms"] / row["graph_ms"]
        rows.append(row)
        print(f"  x {str(xs):22s} W {str(ws):24s} {name} x{row['main_path_launches']:<6d} "
              f"rel err {rel_err:.2e}  kernel {k_ms:.4f} / {k_ms2:.4f} ms  plain "
              f"{p_ms:.4f} ms  cuDNN {l_ms:.4f} ms  bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})  v1 "
              f"{v1_ms:.4f} ms; as CUDA graphs: kernel {row['graph_ms']:.4f}, "
              f"v1 {row['v1_graph_ms']:.4f} ms  [instance {p.instance}, "
              f"split {p.split}, {p.blocks} blocks]", flush=True)
        if not row["graph_ms"] <= row["v1_graph_ms"]:
            fail(f"{kern.name} is slower than its first design at x {xs} "
                 f"W {ws} {name}: {row['graph_ms']:.4f} > "
                 f"{row['v1_graph_ms']:.4f} ms of device time")
    out[f"{kern.name}_shapes"] = rows
    out[f"{kern.name}_v1_launches"] = kern.v1_launches - v1_before
    return rows


def ptxas_registers(build_log, name):
    """{instance: registers} from nvcc's -Xptxas -v log; ``name`` maps a
    mangled kernel name to a readable one."""
    regs, entry = {}, None
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            entry = name(ln.split("'")[1])
        elif entry is not None and "Used" in ln and "registers" in ln:
            regs[entry] = int(ln.split("Used")[1].split()[0])
    return regs


def phase_kernel_design(torch, stencil, kern, rows, out):
    """Phase 5a's or 5b's second half: each instance's registers and
    static SASS counts, and bitwise-equal repeat launches at the busiest
    fine shape and at the most-split coarse shape."""
    from pynama_tpu_torch.scripts import stencil_breakdown as sb

    regs = ptxas_registers(kern.build_log, sb.instance_name)
    sass = sb.library_sass(kern, sb.SASS_OPS_3D) or {}
    design = {}
    for name in sorted(set(regs) | set(sass)):
        design[name] = {"registers": regs.get(name), **sass.get(name, {})}
        print(f"  {name}: {regs.get(name)} registers; static SASS "
              + ", ".join(f"{op} {n}" for op, n in sass.get(name, {}).items()),
              flush=True)
    if not sass:
        print("  no cuobjdump: no SASS counts", flush=True)
    f32 = [r for r in rows if r["dtype"] == "float32"]
    fine = f32[0]
    coarse = max(f32, key=lambda r: r["plan"]["split"])
    if coarse["plan"]["split"] < 2:
        fail(f"{kern.name}: no logged shape splits K, so none checks the "
             "split")
    repeats = [repeat_bitwise(torch, kern, tuple(r["x"]), tuple(r["W"]),
                              "float32") for r in (fine, coarse)]
    out[f"{kern.name}_design"] = {"instances": design, "repeats": repeats}


def repeat_bitwise(torch, kern, xs, ws, name):
    """Four launches of ``kern`` on the same seeded inputs of a shape in
    dtype ``name``; fails unless they agree bit for bit."""
    import numpy as np

    dtype = getattr(torch, name)
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.normal(size=xs), dtype=dtype, device="cuda")
    W = torch.as_tensor(rng.normal(size=ws), dtype=dtype, device="cuda")
    first = kern(x, W)
    same = all(bool(torch.equal(kern(x, W), first)) for _ in range(3))
    torch.cuda.synchronize()
    p = kern.plan(xs, ws, dtype)
    plan = {"instance": p.instance, "split": p.split, "blocks": p.blocks,
            "vec": p.vec, "useful_positions": p.useful_positions}
    print(f"  x {xs} W {ws} {name}, instance {p.instance}, split {p.split}: "
          f"4 launches bitwise equal: {same}", flush=True)
    if not same:
        fail(f"{kern.name} is not deterministic at x {xs}, W {ws}, {name}")
    return {"x": list(xs), "W": list(ws), "dtype": name, "plan": plan,
            "bitwise_equal": same}


def phase_main(torch, stencil, kern, make_problem, key, out, extra=None,
               steps=3, on_step=None):
    """setup() + run(max_steps=steps) through the kernels, the launch
    counts set to 0 just before and read just after; on_step(p, n, t,
    vel) runs after each accepted step, its time left out of the step
    times."""
    marks = []  # (the step's end, launches, KLE solves, the hook's end)

    def callback(n, t, dt, vort, vel):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if on_step is not None:
            on_step(p, n, t, vel)
            torch.cuda.synchronize()
        marks.append((now, kern.launches, len(p.cg_iters),
                      time.perf_counter() if on_step else now))

    for k in stencil.LIBRARIES:
        k.reset_counts()
    gc.collect()  # earlier phases' problems can hang on in reference cycles
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    p = make_problem()
    p.setup()
    torch.cuda.synchronize()
    t_setup = time.perf_counter()
    setup_launches = kern.launches
    vort, t, n = p.run(max_steps=steps, callback=callback)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k.name: k.launches for k in stencil.KERNELS.values()}
    logged = dict(kern.shapes)

    dofs = p.mesh.n_nodes * p.dim
    norm = float(torch.linalg.norm(vort))
    if n != steps or len(marks) != steps:
        fail(f"{key}: expected {steps} accepted steps, got {n}")
    if not math.isfinite(norm) or not bool(torch.isfinite(vort).all()):
        fail(f"{key}: final vorticity is not finite")
    step_ms = [1e3 * (b[0] - a[3]) for a, b in zip(marks, marks[1:])]
    step_launches = [b[1] - a[1] for a, b in zip(marks, marks[1:])]
    step_iters = [p.cg_iters[a[2]:b[2]] for a, b in zip(marks, marks[1:])]
    if not all(s > 0 for s in step_launches) or launches[kern.name] <= 0:
        fail(f"{key}: the main path launched no {kern.name} kernel")
    iters = p.cg_iters
    res = {
        "nelem": list(p.nelem), "ngl": p.ngl, "velocity_dofs": dofs,
        "dtype": str(p.dtype).replace("torch.", ""), "steps": n, "t": t,
        "setup_s": t_setup - t0,
        "first_step_incl_initial_rhs_ms": 1e3 * (marks[0][0] - t_setup),
        "ms_per_step": sum(step_ms) / len(step_ms), "step_ms": step_ms,
        "run_s_incl_final_solve": t_end - t_setup,
        "kle_solves": len(iters), "cg_iters_per_solve": sum(iters) / len(iters),
        "cg_iters": iters, "stencil_launches": launches[kern.name],
        "launches_by_kernel": launches,
        "stencil_launches_setup": setup_launches,
        "stencil_launches_per_step": step_launches,
        "cg_iters_per_step": step_iters,
        "logged_shapes": [[list(s[0]), list(s[1]), s[2], c]
                          for s, c in logged.items()],
        "vort_norm": norm, "mg_ratios": p.mg.ratios,
        "lam_max": p.mg.lam_max,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "mem_at_start_gib": mem0 / 2**30,
    }
    if extra is not None:
        res.update(extra(p, vort))
    out[key] = res
    print(f"  {dofs} velocity dofs, setup {res['setup_s']:.2f} s, "
          f"{res['ms_per_step']:.1f} ms/step (steps 2-{steps}), first step "
          f"incl. initial RHS {res['first_step_incl_initial_rhs_ms']:.1f} ms, "
          f"peak memory {res['peak_mem_gib']:.2f} GiB "
          f"({res['mem_at_start_gib']:.2f} allocated at the start)",
          flush=True)
    print(f"  {len(iters)} KLE solves, {res['cg_iters_per_solve']:.2f} CG "
          f"iterations per solve (max {max(iters)}), {kern.name} launches "
          f"per step {step_launches}, total {launches}; |vort| = "
          f"{norm:.6e}; {len(logged)} shapes logged", flush=True)
    return res, logged


def channel_extra(torch):
    def extra(p, vort):
        one = torch.tensor([1.0, 0.0, 0.0], dtype=p.vel.dtype,
                           device=p.vel.device)
        dev = float((p.vel.reshape(-1, 3) - one).abs().max())
        print(f"  max |u - (1,0,0)| = {dev:.3e}, max |vort| = "
              f"{float(vort.abs().max()):.3e}", flush=True)
        if not math.isfinite(dev):
            fail("channel3d: final velocity is not finite")
        return {"max_abs_u_minus_uniform": dev,
                "max_abs_vort": float(vort.abs().max())}
    return extra


def phase_plain_compare(torch, stencil, kern, make_problem, key, out,
                        exact_limit=None, limit=1e-4, t_rtol=0.0):
    """One small run through the kernel and one with the plain version
    forced; the vorticities must agree within ``limit`` and the final
    times within ``t_rtol`` (0: equal; an adaptive dt differs in its last
    bits when wlte does). With exact_limit, the velocity must match the
    problem's exact field. Returns the kernel run's and the plain run's
    problems."""
    runs = {}
    for mode in ("kernel", "plain"):
        before = kern.launches
        saved = stencil.conv_blocked
        if mode == "plain":
            stencil.conv_blocked = stencil.conv_blocked_plain
        try:
            p = make_problem().setup()
            vort, t, n = p.run(max_steps=3)
        finally:
            stencil.conv_blocked = saved
        runs[mode] = (p, vort, t, n, kern.launches - before)
    (pk, vk, tk, nk, lk), (_, vp, tp, np_, lp) = runs["kernel"], runs["plain"]
    rel = float(torch.linalg.norm(vk - vp) / torch.linalg.norm(vp))
    res = {"nelem": list(pk.nelem), "steps": [nk, np_], "t": [tk, tp],
           "vort_rel_diff": rel, "launches": [lk, lp]}
    msg = (f"  {'x'.join(map(str, pk.nelem))}: steps {nk}/{np_}, t {tk:.4g}, "
           f"vorticity rel diff {rel:.3e} (limit {limit:g}), launches kernel "
           f"{lk} / plain {lp}")
    if exact_limit is not None:
        vel_e, _ = pk.exact_fields(tk)
        err = float(torch.linalg.norm(pk.vel - vel_e.reshape(-1))
                    / torch.linalg.norm(vel_e))
        res["vel_rel_err_vs_exact"] = err
        msg += f"; velocity rel err vs exact {err:.3e} (limit {exact_limit})"
    out[key] = res
    print(msg, flush=True)
    res["t_rel_diff"] = abs(tk - tp) / abs(tp)
    if nk != np_ or res["t_rel_diff"] > t_rtol or lk <= 0 or lp != 0:
        fail(f"{key}: kernel and plain runs differ in steps, t ({tk!r} vs "
             f"{tp!r}) or launches")
    if not rel <= limit:
        fail(f"{key}: vorticity kernel vs plain: {rel:.3e} > {limit:g}")
    if exact_limit is not None and not res["vel_rel_err_vs_exact"] < \
            exact_limit:
        fail(f"{key}: velocity error vs exact {res['vel_rel_err_vs_exact']}")
    return pk, runs["plain"][0]


def launch_split(torch, kern, shapes):
    """A ``kern.shapes`` log's launches by instance and by dtype."""
    inst, dtypes = {}, {"float32": 0, "float64": 0}
    for (xs, ws, name), n in shapes.items():
        i = kern.plan(xs, ws, getattr(torch, name)).instance
        inst[i] = inst.get(i, 0) + n
        dtypes[name] += n
    return dict(sorted(inst.items())), dtypes


def parity_extra(torch, kern, held):
    """Phase 10a's record beside phase_main's: refinement rounds and
    inner CG iterations per solve, and stencil2d's launches by instance
    and dtype; keeps the problem in ``held`` for phase 10b."""
    def extra(p, vort):
        held["p"] = p
        inst, dtypes = launch_split(torch, kern, kern.shapes)
        rounds, iters = p.ir_rounds, p.cg_iters
        res = {"rounds_per_solve": sum(rounds) / len(rounds),
               "max_rounds": max(rounds), "ir_rounds": rounds,
               "inner_cg_iters_per_solve": sum(iters) / len(iters),
               "launches_by_instance": inst, "launches_by_dtype": dtypes}
        print(f"  {len(rounds)} refined solves: {res['rounds_per_solve']:.2f} "
              f"rounds per solve (max {max(rounds)}), "
              f"{res['inner_cg_iters_per_solve']:.2f} inner CG iterations "
              f"per solve; {kern.name} launches by instance {inst}, by "
              f"dtype {dtypes}", flush=True)
        if not min(dtypes.values()) > 0:
            fail(f"parity leg: {kern.name} launches by dtype {dtypes}; "
                 "both must be > 0")
        if len(rounds) != len(iters) or rounds[0] < 1:
            fail(f"parity leg: {len(rounds)} refinement records for "
                 f"{len(iters)} solves, or a cold first solve took no "
                 f"round: {rounds}")
        return res
    return extra


def phase_parity_residual(torch, p, out):
    """Phase 10b, bench.py's self-check (bench.py:344-373): solve_ir on
    the final (no-slip) mask at rtol 1e-8, at the initial vorticity and
    after 10a's last step; the true float64 relative residual is formed
    anew."""
    from pynama_tpu_torch.kle import solve_ir

    name = "free_mask"
    mask, u_bc = p.free_mask_b, p._solver_bc(0.0)
    rows = []
    for label, w in (
            ("initial", p._blk(p.initial_vorticity())),
            (f"after step {PARITY_STEPS}",
             p._blk(p.vort.reshape(p._gshape(p.dim_w))))):
        res = solve_ir(p.system, p.system32, w, u_bc, mask,
                       p.free_mask32_b, rtol=PARITY_RTOL,
                       maxiter=p.kle_maxiter, inner_rtol=p.kle_inner_rtol,
                       m_inv32=p._minv[name],
                       corrections=p._frees_boundary[name])
        b = p.system.rhs(w, u_bc, mask)
        r = b - p.system.apply_masked(res.x, mask)
        rel = float(torch.linalg.norm(r) / torch.linalg.norm(b))
        rows.append({"vorticity": label, "true_rel_residual": rel,
                     "rounds": res.rounds, "inner_cg_iters": res.iters,
                     "solve_ir_rel_resnorm": float(
                         res.resnorm / torch.linalg.norm(b))})
        print(f"  {label} vorticity: true float64 relative residual "
              f"{rel:.3e} (limit {PARITY_RTOL:g}), {res.rounds} rounds, "
              f"{res.iters} inner CG iterations", flush=True)
        if not rel <= PARITY_RTOL:
            fail(f"parity self-check at the {label} vorticity: {rel:.3e} "
                 f"> {PARITY_RTOL:g}")
    out["parity_residual"] = rows


def phase_refine3d(torch, kern, make_problem, out):
    """Phase 10d: one refined solve_kle of the 3D Taylor-Green case at
    t_start; the true float64 residual, formed anew, and the velocity
    against the exact field."""
    from collections import Counter

    p = make_problem().setup()
    t = p.t_start
    w = p.initial_vorticity()
    before = Counter(kern.shapes)
    u = p.solve_kle(t, w)
    torch.cuda.synchronize()
    inst, dtypes = launch_split(torch, kern, Counter(kern.shapes) - before)
    b = p.system.rhs(p._blk(w), p._solver_bc(t), p.free_mask_b)
    r = b - p.system.apply_masked(p._blk(u), p.free_mask_b)
    rel = float(torch.linalg.norm(r) / torch.linalg.norm(b))
    vel_e, _ = p.exact_fields(t)
    err = float(torch.linalg.norm(u.reshape(-1) - vel_e.reshape(-1))
                / torch.linalg.norm(vel_e))
    out["refine3d"] = {"nelem": list(p.nelem), "true_rel_residual": rel,
                       "vel_rel_err_vs_exact": err,
                       "rounds": p.ir_rounds, "inner_cg_iters": p.cg_iters,
                       "launches_by_instance": inst,
                       "launches_by_dtype": dtypes}
    print(f"  {'x'.join(map(str, p.nelem))}: true float64 relative residual "
          f"{rel:.3e} (limit {PARITY_RTOL:g}), velocity rel err vs exact "
          f"{err:.3e} (limit 0.15), rounds {p.ir_rounds}, inner CG "
          f"{p.cg_iters}, {kern.name} launches by instance {inst}",
          flush=True)
    if not rel <= PARITY_RTOL:
        fail(f"3D refined solve: true residual {rel:.3e}")
    if not err < 0.15:
        fail(f"3D refined solve: velocity error vs exact {err:.3e}")
    if not min(dtypes.values()) > 0:
        fail(f"3D refined solve: {kern.name} launches by dtype {dtypes}; "
             "both must be > 0")


def phase_logged_kernels(torch, stencil, kern, logged, launches, key,
                         out):
    """Phases 10e, 12e, 13g and 16: the kernel against its plain version
    at every shape a leg logged, with device time (the calls captured in
    a CUDA graph), the plain version's time, the bound and the cuDNN
    convolution's time (TF32 off); the leg's launches and device time by
    instance (launches x device time per shape)."""
    import torch.nn.functional as tnf

    from pynama_tpu_torch.scripts.stencil_sweep import graph_ms

    torch.backends.cudnn.allow_tf32 = False
    rows, inst = [], {}
    for (xs, ws, name), n in sorted(
            logged.items(), key=lambda kv: -kv[1] * _flops(*kv[0][:2])):
        x, W, _, abs_err, rel_err = checked_inputs(torch, stencil, kern,
                                                   xs, ws, name)
        reps = max(3, min(20, int(5e10 / _flops(xs, ws))))
        dev = graph_ms(lambda: kern(x, W), reps)
        p_ms = event_ms(torch, lambda: stencil.conv_blocked_plain(x, W),
                        reps)
        bound = 1e3 * max(bound_times(xs, ws, name)[:2])
        i = kern.plan(xs, ws, getattr(torch, name)).instance
        row = {"x": list(xs), "W": list(ws), "dtype": name,
               "instance": i, "main_path_launches": n,
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "graph_ms": dev, "plain_ms": p_ms, "bound_ms": bound,
               "library_ms": event_ms(torch, library_call(tnf, x, W)[0],
                                      reps)}
        rows.append(row)
        e = inst.setdefault(i, {"launches": 0, "device_ms": 0.0})
        e["launches"] += n
        e["device_ms"] += n * dev
        print(f"  x {str(xs):16s} W {str(ws):20s} {name} x{n:<6d} "
              f"instance {i}: rel err {rel_err:.2e}, device {dev:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {bound:.4f} ms, cuDNN "
              f"{row['library_ms']:.4f} ms", flush=True)
    if sum(e["launches"] for e in inst.values()) != launches:
        fail(f"{key}: the logged shapes hold {inst}, the leg counted "
             f"{launches} launches")
    for i, e in sorted(inst.items()):
        print(f"  instance {i}: {e['launches']} launches x device time "
              f"per shape = {e['device_ms']:.1f} ms (the whole leg)",
              flush=True)
    out[key] = {"shapes": rows, "by_instance": inst}
    return rows


def phase_profile(torch, kern, make_problem, sl, key, out):
    from torch.profiler import ProfilerActivity, profile

    p = make_problem().setup()
    prof = profile(activities=[ProfilerActivity.CUDA])
    marks = []

    def callback(n, t, dt, vort, vel):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), kern.launches, len(p.cg_iters)))
        if n == 2:
            prof.start()
        elif n == 3:
            prof.stop()

    p.run(max_steps=3, callback=callback)
    (_, l2, s2), (t3, l3, s3) = marks[1], marks[2]
    launches, iters = l3 - l2, p.cg_iters[s2:s3]
    if launches != sl["stencil_launches_per_step"][1] or \
            iters != sl["cg_iters_per_step"][1]:
        fail(f"profiled step 3 ({launches} launches, CG {iters}) is not the "
             f"work of the main path's step 3 "
             f"({sl['stencil_launches_per_step'][1]}, "
             f"{sl['cg_iters_per_step'][1]})")
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if "CUDA" in str(e.device_type) and dev_us > 0:
            rows.append({"name": e.key, "calls": e.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    dev_ms = sum(r["device_ms"] for r in rows)
    if dev_ms <= 0:
        fail("the profiler recorded no device time")
    wall_ms = sl["step_ms"][1]
    stencil_ms = sum(r["device_ms"] for r in rows if kern.name in r["name"])
    res = {
        "step": 3, "step_wall_ms": wall_ms,
        "profiled_step_wall_ms": 1e3 * (t3 - marks[1][0]),
        "device_kernel_ms": dev_ms, "device_busy_share": dev_ms / wall_ms,
        f"{kern.name}_device_ms": stencil_ms, "stencil_launches": launches,
        "cg_iters": iters, "top": rows[:25],
    }
    out[key] = res
    print(f"  step 3: {wall_ms:.1f} ms wall without the profiler "
          f"({res['profiled_step_wall_ms']:.1f} ms with it), kernels "
          f"{dev_ms:.1f} ms, device busy {100 * dev_ms / wall_ms:.1f}%; "
          f"{kern.name} {stencil_ms:.1f} ms over {launches} launches",
          flush=True)
    for r in rows[:12]:
        print(f"  {r['device_ms']:9.2f} ms {r['calls']:7d}x  {r['name'][:80]}",
              flush=True)


def keep_run(held, name, extra=None, problem=False):
    """A phase_main ``extra`` that keeps the run's final vorticity (with
    ``problem``, the pair (problem, vorticity)) in ``held[name]`` for
    phase 11. Only 11a keeps its problem: a kept problem's tensors would
    count in every later phase's peak memory."""
    def fn(p, vort):
        held[name] = (p, vort) if problem else vort
        return extra(p, vort) if extra is not None else {}
    return fn


def step3_iters(res):
    return sum(res["cg_iters_per_step"][1])


def history_leaves(aux_ws):
    """The tensors of a ws history's two slot stacks (H1, H2)."""
    from pynama_tpu_torch.solvers.rk import aux_map

    leaves = []
    aux_map(leaves.append, (aux_ws[0], aux_ws[1]))
    return leaves


def compare_ws(torch, out, key, base_key, vort, base_vort):
    """A ws leg against its ws-off counterpart: the final vorticity
    (within WS_LIMIT), ms/step, step 3's CG iterations and peak memory
    side by side."""
    ws, base = out[key], out[base_key]
    rel = float(torch.linalg.norm(vort - base_vort)
                / torch.linalg.norm(base_vort))
    ws.update(against=base_key, vort_rel_diff=rel,
              step3_cg_iters=step3_iters(ws),
              step3_cg_iters_against=step3_iters(base),
              ms_per_step_against=base["ms_per_step"],
              peak_mem_gib_against=base["peak_mem_gib"],
              mem_at_start_gib_against=base["mem_at_start_gib"])
    per_step = [[sum(s) for s in r["cg_iters_per_step"]] for r in (ws, base)]
    print(f"  against {base_key}: vorticity rel diff {rel:.3e} (limit "
          f"{WS_LIMIT:g}); CG iterations in steps 2-3 {per_step[0]} vs "
          f"{per_step[1]}; {ws['ms_per_step']:.1f} vs "
          f"{base['ms_per_step']:.1f} ms/step; peak memory "
          f"{ws['peak_mem_gib']:.3f} vs {base['peak_mem_gib']:.3f} GiB "
          f"({ws['mem_at_start_gib']:.3f} and {base['mem_at_start_gib']:.3f} "
          "allocated at their starts)", flush=True)
    if not rel <= WS_LIMIT:
        fail(f"{key}: final vorticity {rel:.3e} off {base_key}'s")


def phase_ws_scan(torch, stencil, kern, p, base_vort, out):
    """Phase 11b, bench.py's float32 cavity step (bench.py:305-326) on
    phase 11a's problem: the host dt controller around one scan attempt
    with ws on, from make_ws_state after the initial RHS, 3 steps at
    cavity_config's dt (bench.py's 1e-3 lies above the explicit limit,
    see cavity_config), counts reset just before and read just after."""
    from pynama_tpu_torch.solvers.rk import (make_attempt_host_stepper,
                                             make_bs5_scan_attempt,
                                             make_ws_state)

    dt = cavity_config(0)["time-solver"]["max-dt"]
    step = make_attempt_host_stepper(make_bs5_scan_attempt(
        p.transport_rhs, atol=1e12, rtol=1e12, ws_extrapolate=True))
    for k in stencil.LIBRARIES:
        k.reset_counts()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    first = len(p.cg_iters)
    w, vel = p._blk(p.initial_vorticity()), p._blk(p.zero_vel())
    t = 0.0
    f1, vel = p.transport_rhs(t, w, vel)
    vel = make_ws_state(vel, t)
    marks = []
    for _ in range(3):
        res = step(w, t, dt, vel, f1, 1e9)
        w, t, vel, f1 = res.y, res.t, res.aux, res.f_new
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), kern.launches, len(p.cg_iters)))
    launches = kern.launches
    vort = p._unblk(w).reshape(-1)
    if not bool(torch.isfinite(vort).all()):
        fail("ws_scan: final vorticity is not finite")
    step_ms = [1e3 * (b[0] - a[0]) for a, b in zip(marks, marks[1:])]
    iters = p.cg_iters[first:]
    step_iters = [p.cg_iters[a[2]:b[2]] for a, b in zip(marks, marks[1:])]
    hist = history_leaves(vel)
    leaves = {h.device.type for h in hist} | {str(h.dtype) for h in hist}
    out["ws_scan"] = {
        "t": t, "dt": dt, "ms_per_step": sum(step_ms) / len(step_ms),
        "step_ms": step_ms, "kle_solves": len(iters),
        "cg_iters_per_solve": sum(iters) / len(iters), "cg_iters": iters,
        "cg_iters_per_step": step_iters, "stencil_launches": launches,
        "stencil_launches_per_step": [b[1] - a[1] for a, b in
                                      zip(marks, marks[1:])],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "mem_at_start_gib": mem0 / 2**30,
        "history_bytes": sum(h.numel() * h.element_size() for h in hist),
        "history_leaves": sorted(leaves),
    }
    r = out["ws_scan"]
    print(f"  t {t:.6g}, {r['ms_per_step']:.1f} ms/step (steps 2-3), "
          f"{len(iters)} KLE solves, {r['cg_iters_per_solve']:.2f} CG "
          f"iterations per solve, per step {[sum(s) for s in step_iters]}, "
          f"{kern.name} launches {launches}; ws history "
          f"{r['history_bytes'] / 1e6:.1f} MB on {sorted(leaves)}",
          flush=True)
    if launches <= 0:
        fail(f"ws_scan: launched no {kern.name} kernel")
    if leaves != {"cuda", "torch.float32"}:
        fail(f"ws_scan: the ws history left the card or float32: {leaves}")
    compare_ws(torch, out, "ws_scan", "ws_cavity", vort, base_vort)


def phase_ws_legs(torch, stencil, phase, held, out):
    """Phase 11 (see the module's docstring); ``held`` holds phases 3's
    and 4's final vorticities. Returns phase_main's records of 11a and
    11c."""
    from pynama_tpu_torch.cases.cavity import CavityProblem
    from pynama_tpu_torch.cases.uniform import UniformFlowProblem

    k2, k3, F32 = stencil.KERNEL, stencil.KERNEL3D, torch.float32
    ws = {"kle-ws-extrapolate": True}
    sl11a, _ = phase(
        "ws_cavity", "[11a] ws leg: 384x384 cavity with kle-ws-extrapolate, "
        "3 steps",
        lambda: phase_main(torch, stencil, k2,
                           lambda: CavityProblem({**cavity_config(384), **ws},
                                                 dtype=F32),
                           "ws_cavity", out,
                           extra=keep_run(held, "ws_cavity", problem=True)))
    p11, vort11 = held.pop("ws_cavity")
    # phase 3's vorticity stays in held for phase 13c
    compare_ws(torch, out, "ws_cavity", "cavity", vort11, held["cavity"])
    phase("ws_scan", "[11b] ws leg: bench.py's step (scan attempt + host "
          "stepper, ws on) on 11a's problem, 3 steps",
          lambda: phase_ws_scan(torch, stencil, k2, p11, vort11, out))
    del p11  # 11c's peak memory must not count 11a's problem
    sl11c, _ = phase(
        "ws_channel3d", "[11c] ws leg: channel3d with kle-ws-extrapolate, "
        "3 steps",
        lambda: phase_main(torch, stencil, k3,
                           lambda: UniformFlowProblem(
                               {**channel3d_config(), **ws}, dtype=F32),
                           "ws_channel3d", out,
                           extra=keep_run(held, "ws_channel3d",
                                           channel_extra(torch))))
    compare_ws(torch, out, "ws_channel3d", "channel3d",
               held.pop("ws_channel3d"), held.pop("channel3d"))
    phase("plain_compare_ws",
          "[11d] 16x16 cavity with ws: kernel vs plain version on the card",
          lambda: phase_plain_compare(
              torch, stencil, k2,
              lambda: CavityProblem({**cavity_config(16), **ws}, dtype=F32),
              "plain_compare_ws", out, limit=WS_LIMIT))
    return sl11a, sl11c


def ibm_slip(p, t, vel=None):
    """max |H u - U_body| at t of a corrected velocity (grid or flat;
    default the run's final one)."""
    X, Ub = p._body_state(t)
    nodes, weights = p.coupling.windows(X)
    vel = p.vel if vel is None else vel.reshape(-1)
    return float((p.coupling.interp(vel, nodes, weights) - Ub).abs().max())


def grid_from_blocked(xb, P, npts):
    """The blocked layout written out apart from the port's converters:
    block (b1, b2) holds grid nodes (b1*P + i, b2*P + j), 0 <= i, j < P,
    in channels (i, j, k); the grid is cropped to its npts."""
    B1, B2, C = xb.shape
    k = C // (P * P)
    g = xb.reshape(B1, B2, P, P, k).permute(0, 2, 1, 3, 4)
    return g.reshape(B1 * P, B2 * P, k)[:npts[0], :npts[1]]


def ibm_layout(torch, p):
    """Witnesses that the coupling read and wrote the velocity in the
    grid layout, which the slip alone cannot show (the correction
    enforces H u = U_body on whatever field it is given): the port's
    blocked <-> grid converters agree bit for bit with grid_from_blocked
    on the final velocity; every boundary node of the flat velocity,
    found by the mesh's numbering (node = iy*npx + ix), holds the far
    field exactly; and the field is not uniform (so the boundary test
    could fail)."""
    npts = tuple(reversed(p.mesh.npts))
    grid = p.vel.reshape(npts + (p.dim,))
    vb = p._blk(grid)
    same = bool(torch.equal(
        grid_from_blocked(vb, p._solver_ngl - 1, npts), grid)) and \
        bool(torch.equal(p._unblk(vb), grid))
    u_inf = torch.as_tensor(p.cte_value, dtype=grid.dtype,
                            device=grid.device)
    dev = (grid - u_inf).abs().amax(dim=-1)
    edge = torch.cat([dev[0], dev[-1], dev[:, 0], dev[:, -1]])
    return {"layout_converters_equal": same,
            "boundary_minus_far_field": float(edge.max()),
            "max_minus_far_field": float(dev.max())}


def ibm_extra(torch, kern, key, held):
    """A phase_main ``extra`` for phase 12's legs: the slip at the body,
    the last cd, the flux-CG iterations of every post-step (the initial
    one, then the step's and the force floor's, 2 a step), stencil2d's
    launches by instance and dtype (only float64, or under kle-refine
    both float64 and float32), and whether the body moved; keeps
    (problem, vorticity) in held[key]."""
    def extra(p, vort):
        t = p.t_history[-1]
        slip = ibm_slip(p, t)
        cd = p.cd_history[-1][0]
        flux = list(p.coupling.cg_iters)
        inst, dtypes = launch_split(torch, kern, kern.shapes)
        moved = float(abs(p.body.coords_at(t) - p.body.coords_at(0.0)).max())
        layout = ibm_layout(torch, p)
        res = {**layout, "slip": slip, "cd_history": p.cd_history,
               "cl_history": p.cl_history, "cd_raw_history": p.cd_raw_history,
               "dt_history": p.dt_history, "t_history": p.t_history,
               "flux_cg_iters": flux,
               "flux_cg_iters_per_post_step": sum(flux) / len(flux),
               "lagrange_points": p.body.n_nodes, "body_moved": moved,
               "launches_by_instance": inst, "launches_by_dtype": dtypes}
        print(f"  slip max |Hu - U_body| {slip:.3e} (limit {SLIP_LIMIT:g}), "
              f"cd {[c[0] for c in p.cd_history]}, dt {p.dt_history}; "
              f"{p.body.n_nodes} Lagrange points, flux CG {flux} "
              f"({res['flux_cg_iters_per_post_step']:.1f} per post-step); "
              f"body moved {moved:.4g}; {kern.name} launches by instance "
              f"{inst}, by dtype {dtypes}", flush=True)
        print(f"  layout: converters equal to the grid definition "
              f"{layout['layout_converters_equal']}; max |u - u_inf| on "
              f"the boundary {layout['boundary_minus_far_field']:.3e} "
              f"(limit {LAYOUT_LIMIT:g} u_ref), over the field "
              f"{layout['max_minus_far_field']:.3e}", flush=True)
        if not layout["layout_converters_equal"] or \
                not layout["boundary_minus_far_field"] <= LAYOUT_LIMIT * p.u_ref or \
                not layout["max_minus_far_field"] > 0.1 * p.u_ref:
            fail(f"{key}: the velocity's grid layout: {layout}")
        if not slip < SLIP_LIMIT:
            fail(f"{key}: slip at the body {slip:.3e}")
        if not cd > 0:
            fail(f"{key}: last cd {cd} is not positive")
        if p.body.is_moving and not moved > 0:
            fail(f"{key}: the body did not move")
        if p._refine and (dtypes["float64"] <= 0 or dtypes["float32"] <= 0):
            fail(f"{key}: {kern.name} launches by dtype {dtypes}; the "
                 "refined path must launch both float64 (the defects, the "
                 "transport chain) and float32 (the V-cycles)")
        if not p._refine and (dtypes["float64"] <= 0 or dtypes["float32"]):
            fail(f"{key}: {kern.name} launches by dtype {dtypes}; the "
                 "float64 path must launch only the float64 instance")
        held[key] = p, vort
        return res
    return extra


def phase_ibm_repeat(torch, make_problem, held, out):
    """12a's run again under torch.cuda's sync debug mode: the host syncs
    of each step (every synchronizing call warns once), beside the reads
    that the CG loops alone account for (2 + iterations a solve, KLE and
    flux), and whether the vorticity, the CG iteration lists and the
    force histories equal the first run's bit for bit."""
    import warnings

    import numpy as np

    p0, vort0 = held.pop("ibm_static")
    p = make_problem().setup()
    marks = []

    def callback(n, t, dt, vort, vel):
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        marks.append((syncs, len(p.cg_iters), len(p.coupling.cg_iters)))

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        vort, t, n = p.run(max_steps=3, callback=callback)
        torch.cuda.set_sync_debug_mode("default")
    steps = list(zip([(0, 0, 0)] + marks, marks))
    syncs = [b[0] - a[0] for a, b in steps]
    cg_reads = [sum(2 + i for i in p.cg_iters[a[1]:b[1]])
                + sum(2 + i for i in p.coupling.cg_iters[a[2]:b[2]])
                for a, b in steps]
    # the same windows, spread 4 times
    X, _ = p._body_state(t)
    nodes, weights = p.coupling.windows(X)
    q = torch.as_tensor(np.random.default_rng(12).normal(
        size=(X.shape[0], 2)), dtype=p.dtype, device="cuda")
    s0 = p.coupling.spread(q, nodes, weights, p.mesh.n_nodes)
    spread_same = all(bool(torch.equal(
        p.coupling.spread(q, nodes, weights, p.mesh.n_nodes), s0))
        for _ in range(3))
    res = {
        "vort_bitwise_equal": bool(torch.equal(vort, vort0)),
        "vort_max_abs_diff": float((vort - vort0).abs().max()),
        "cg_iters_equal": p.cg_iters == p0.cg_iters,
        "flux_cg_iters_equal": p.coupling.cg_iters == p0.coupling.cg_iters,
        "cd_history_equal": p.cd_history == p0.cd_history,
        "spread_repeats_bitwise_equal": spread_same,
        "host_syncs_per_step": syncs, "cg_host_reads_per_step": cg_reads,
        "t": t, "steps": n,
    }
    out["ibm_static_repeat"] = res
    print(f"  repeat of 12a: vorticity bitwise equal "
          f"{res['vort_bitwise_equal']} (max abs diff "
          f"{res['vort_max_abs_diff']:.3e}), KLE CG lists equal "
          f"{res['cg_iters_equal']}, flux CG lists equal "
          f"{res['flux_cg_iters_equal']}, cd equal "
          f"{res['cd_history_equal']}; spread x4 bitwise equal "
          f"{spread_same}; host syncs per step (step 1 with the initial "
          f"condition) {syncs}, of which the CG loops' reads {cg_reads}",
          flush=True)
    if n != 3 or not bool(torch.isfinite(vort).all()):
        fail("12a repeat: not 3 steps, or the vorticity is not finite")


def problem_tensors(torch, p, skip=()):
    """Every tensor a problem (or a distributed wrapper) reaches through
    its attributes: its own, and those of the port's objects, lists,
    tuples, dicts and closures it holds (systems, operators, masks,
    multigrid levels, the V-cycles' closures, the coupling), except
    through the objects in ``skip``."""
    found, seen = [], {id(x) for x in skip}

    def walk(x):
        if id(x) in seen:
            return
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            found.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif getattr(x, "__closure__", None):
            for c in x.__closure__:
                try:
                    walk(c.cell_contents)
                except ValueError:  # a cell not yet filled
                    pass
        elif type(x).__module__.startswith("pynama_tpu_torch") and \
                hasattr(x, "__dict__"):
            for v in vars(x).values():
                walk(v)

    walk(p)
    return found


def ibm_refine_leg(torch, stencil, key, tag, make_problem, check, out):
    """12f and 12g (``tag``): a configuration under kle-refine through
    phase_main, IBM_REFINE_STEPS steps: the slip after every step,
    refinement rounds and inner CG iterations a step, one raw lift entry
    a step, every tensor of the problem on cuda:0, the inner system
    float32; plus ibm_extra's checks (stencil2d launching both float64
    and float32) and those of ``check(p, vort)``, whose record joins the
    leg's."""
    from pynama_tpu_torch.scripts.ibm_regression import StepSolves

    k2, held, rows, steps = stencil.KERNEL, {}, [], IBM_REFINE_STEPS
    solves = []

    def on_step(p, n, t, vel):
        if not solves:  # step 1 counts the initial solves too
            solves.append(StepSolves(p, mark=(0, 0)))
        rows.append({"step": n, "slip": ibm_slip(p, t, vel), **solves[0]()})

    checks = ibm_extra(torch, k2, key, held)

    def extra(p, vort):
        res = checks(p, vort)
        devices = sorted({str(x.device) for x in problem_tensors(torch, p)})
        inner = str(p.system32.diag_K.dtype).replace("torch.", "")
        slips = [r["slip"] for r in rows]
        res.update(per_step=rows, slip_per_step=slips, tensor_devices=devices,
                   inner_dtype=inner,
                   cl_raw_history=p.cl_raw_history,
                   rounds_per_solve=sum(p.ir_rounds) / len(p.ir_rounds))
        print(f"  per step (slip, rounds, inner CG, KLE solves): "
              + "; ".join(f"{r['step']}: {r['slip']:.2e}, {r['rounds']}, "
                          f"{r['inner_cg_iters']}, {r['kle_solves']}"
                          for r in rows)
              + f"; {res['rounds_per_solve']:.3f} rounds a solve; inner "
              f"system {inner}; tensors on {devices}; raw lift "
              f"{[c[0] for c in p.cl_raw_history]}", flush=True)
        if len(rows) != steps or not max(slips) < SLIP_LIMIT:
            fail(f"{tag}: slip per step {slips} (limit {SLIP_LIMIT:g})")
        if not p._refine or inner != "float32" or devices != ["cuda:0"]:
            fail(f"{tag}: refine {p._refine}, inner system {inner}, "
                 f"tensors on {devices}")
        if len(p.cl_raw_history) != steps:
            fail(f"{tag}: {len(p.cl_raw_history)} raw lift entries in "
                 f"{steps} steps")
        res.update(check(p, vort))
        return res

    return phase_main(torch, stencil, k2, make_problem, key, out,
                      extra=extra, steps=steps, on_step=on_step)


def ibm_re40_refine_leg(torch, stencil, base, out):
    """12f: 12c's configuration under kle-refine, IBM_REFINE_STEPS steps,
    its final vorticity against 12c's (``base``, the same step count)
    within IBM_REFINE_VORT_LIMIT."""
    from pynama_tpu_torch.cases.immersed import ImmersedBoundaryProblem

    def check(p, vort):
        rel = rel_diff(torch, vort, base)
        print(f"  vorticity vs 12c {rel:.3e} (limit "
              f"{IBM_REFINE_VORT_LIMIT:.3e})", flush=True)
        if not rel <= IBM_REFINE_VORT_LIMIT:
            fail(f"12f: vorticity vs 12c {rel:.3e} > "
                 f"{IBM_REFINE_VORT_LIMIT:.3e}")
        return {"vort_rel_diff_vs_12c": rel,
                "vort_limit": IBM_REFINE_VORT_LIMIT}

    return ibm_refine_leg(
        torch, stencil, "ibm_re40_refine", "12f",
        lambda: ImmersedBoundaryProblem({**ibm_re40_config(),
                                         "kle-refine": True}), check, out)


def ibm_st_leg(torch, stencil, out):
    """12g: the Re-100 Strouhal protocol's configuration (KickedCylinder,
    st_config(): 96x64 under kle-refine), IBM_REFINE_STEPS steps, its
    initial vorticity on cuda:0 in float64, in the grid layout, and
    bitwise kick() of the mesh's nodes."""
    from pynama_tpu_torch.scripts.ibm_regression import (KickedCylinder,
                                                         kick, st_config)

    def check(p, vort):
        w = p.initial_vorticity()
        want = torch.as_tensor(kick(p.mesh.coords)).reshape(p._gshape(1))
        same = bool(torch.equal(w.cpu(), want))
        print(f"  kick on {w.device} ({w.dtype}, {tuple(w.shape)}), "
              f"bitwise kick() of the mesh's nodes: {same}", flush=True)
        if str(w.device) != "cuda:0" or w.dtype != torch.float64 or \
                not same:
            fail(f"12g: the kick on {w.device}, {w.dtype}, "
                 f"{tuple(w.shape)}, bitwise kick() {same}")
        return {"kick_bitwise": same}

    return ibm_refine_leg(torch, stencil, "ibm_st_refine", "12g",
                          lambda: KickedCylinder(st_config()), check, out)


def phase_ibm_legs(torch, stencil, phase, out):
    """Phase 12 (see the module's docstring). Returns phase_main's
    records of 12a, 12b, 12c, 12f and 12g and 12e's rows."""
    from collections import Counter

    from pynama_tpu_torch.cases.immersed import (
        ImmersedBoundaryDynamicProblem, ImmersedBoundaryProblem)

    k2, held = stencil.KERNEL, {}
    legs = {
        "ibm_static": ("[12a] ibm-static.yaml as shipped: 48x48, float64, "
                       "3 steps", ImmersedBoundaryProblem,
                       IBM_CONFIGS["ibm-static"]),
        "ibm_dynamic": ("[12b] ibm-dynamic.yaml as shipped: 48x48, "
                        "float64, 3 steps", ImmersedBoundaryDynamicProblem,
                        IBM_CONFIGS["ibm-dynamic"]),
        "ibm_re40": ("[12c] the Re-40 regression geometry: 144x96, "
                     "float64, 3 steps", ImmersedBoundaryProblem,
                     ibm_re40_config()),
    }
    records, logged = {}, Counter()
    for key, (title, cls, cfg) in legs.items():
        records[key], shapes = phase(
            key, title,
            lambda: phase_main(torch, stencil, k2, lambda: cls(cfg), key, out,
                               extra=ibm_extra(torch, k2, key, held)))
        logged.update(shapes)
        if key == "ibm_static":
            phase("ibm_static_repeat",
                  "[12a] the same run again: bitwise equal? host syncs",
                  lambda: phase_ibm_repeat(
                      torch, lambda: cls(cfg), held, out))
        if key == "ibm_re40":
            base = held["ibm_re40"][1]
        held.clear()
    records["ibm_re40_refine"], shapes = phase(
        "ibm_re40_refine", "[12f] 12c's geometry under kle-refine: float64 "
        f"state, float32 V-cycles, {IBM_REFINE_STEPS} steps",
        lambda: ibm_re40_refine_leg(torch, stencil, base, out))
    logged.update(shapes)
    del base
    records["ibm_st_refine"], shapes = phase(
        "ibm_st_refine", "[12g] the Re-100 Strouhal configuration: the "
        f"kicked cylinder at 96x64 under kle-refine, {IBM_REFINE_STEPS} "
        "steps", lambda: ibm_st_leg(torch, stencil, out))
    logged.update(shapes)

    def plain_compare_ibm():
        pk, pp = phase_plain_compare(
            torch, stencil, k2,
            lambda: ImmersedBoundaryProblem(ibm_small_config(16)),
            "plain_compare_ibm", out, limit=IBM_PLAIN_LIMIT,
            t_rtol=IBM_T_LIMIT)
        a, b = pk.cd_history[-1][0], pp.cd_history[-1][0]
        rel = abs(a - b) / abs(b)
        out["plain_compare_ibm"].update(last_cd=[a, b], last_cd_rel_diff=rel)
        print(f"  last cd kernel {a!r} / plain {b!r}: rel diff {rel:.3e} "
              f"(limit {IBM_CD_LIMIT:g})", flush=True)
        if not rel <= IBM_CD_LIMIT:
            fail(f"12d: last cd kernel vs plain {rel:.3e}")

    phase("plain_compare_ibm",
          "[12d] 16x16 IBM case, float64: kernel vs plain version on the "
          "card", plain_compare_ibm)
    launches = sum(r["stencil_launches"] for r in records.values())

    def kernels_and_repeats():
        rows = phase_logged_kernels(torch, stencil, k2, logged, launches,
                                    "ibm_kernels", out)
        f64 = [r for r in rows if r["dtype"] == "float64"]
        fine = max((r for r in f64 if r["x"][0] != r["x"][1]),
                   key=lambda r: r["main_path_launches"]
                   * _flops(r["x"], r["W"]))
        split = max(f64, key=lambda r: k2.plan(
            tuple(r["x"]), tuple(r["W"]), torch.float64).split)
        out["ibm_kernels"]["repeats"] = [
            repeat_bitwise(torch, k2, tuple(r["x"]), tuple(r["W"]),
                           "float64") for r in (fine, split)]
        return rows

    rows = phase("ibm_kernels",
                 "[12e] stencil2d vs plain version at the IBM legs' shapes "
                 "(12f's and 12g's float32 ones too)", kernels_and_repeats)
    return records, rows


@contextlib.contextmanager
def cli_probe(torch, keep=None):
    """Phase 13's hooks around run_case.main calls: every problem
    run_case.make_problem makes (its ``step_marks``: the host clock after
    each accepted step, synchronized), and the seconds of every checkpoint
    and XDMF save in ``saves``, as (kind, step, seconds); a copy of the
    checkpoint of step ``keep`` as <path>.<step>, which the next save
    would overwrite, made within its save's seconds. Restored on exit."""
    from pynama_tpu_torch import run_case
    from pynama_tpu_torch.io import checkpoint

    rec = {"problems": [], "saves": []}
    make, save = run_case.make_problem, checkpoint.save_checkpoint
    xdmf = None
    if importlib.util.find_spec("h5py") is not None:
        from pynama_tpu_torch.io import xdmf
        save_fields = xdmf.XdmfWriter.save_fields

    def timed(fn, kind):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            step = kw["step"] if kind == "checkpoint" else args[1]
            if kind == "checkpoint" and step == keep:
                shutil.copyfile(args[0], f"{args[0]}.{step}")
            rec["saves"].append((kind, step, time.perf_counter() - t0))
            return res
        return call

    def make_marked(*args, **kw):
        p = make(*args, **kw)
        run, marks = p.run, []

        def run_marked(callback=None, **kw):
            def cb(*a):
                if callback is not None:
                    callback(*a)
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            return run(callback=cb, **kw)

        p.run, p.step_marks = run_marked, marks
        rec["problems"].append(p)
        return p

    run_case.make_problem = make_marked
    checkpoint.save_checkpoint = timed(save, "checkpoint")
    if xdmf is not None:
        xdmf.XdmfWriter.save_fields = timed(save_fields, "xdmf")
    try:
        yield rec
    finally:
        run_case.make_problem = make
        checkpoint.save_checkpoint = save
        if xdmf is not None:
            xdmf.XdmfWriter.save_fields = save_fields


def run_cli_leg(torch, stencil, argvs, keep=None):
    """Each argv through run_case.main in this process, in order, the
    launch counts set to 0 just before the first and read just after the
    last; the checkpoints of step ``keep`` are kept (cli_probe). Returns
    ([(main's result, its problem, its saves)], stencil2d's launches, its
    logged shapes, the seconds)."""
    from collections import Counter

    from pynama_tpu_torch import run_case

    for k in stencil.LIBRARIES:
        k.reset_counts()
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls = []
    for argv in argvs:
        print("  run_case " + " ".join(argv), flush=True)
        with cli_probe(torch, keep) as rec:
            res = run_case.main(argv + ["-log", "WARNING"])
            torch.cuda.synchronize()
        if len(rec["problems"]) != 1:
            fail(f"run_case {argv} made {len(rec['problems'])} problems")
        calls.append((res, rec["problems"][0], rec["saves"]))
    k2 = stencil.KERNEL
    return calls, k2.launches, Counter(k2.shapes), time.perf_counter() - t0


def rel_diff(torch, a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def cli_cavity_legs(torch, stencil, tmp, base_vort, out):
    """13a-13c; returns the legs' (launches, logged shapes)."""
    import numpy as np
    import yaml

    from pynama_tpu_torch.io.checkpoint import load_checkpoint

    legs = {}
    d = os.path.join(tmp, "13a")
    last = CLI_CAVITY_STEPS
    calls, n, shapes, sec = run_cli_leg(torch, stencil, [
        ["-case", "cavity", "-max-steps", str(last), "-opt",
         f"save-n-steps={last // 2}", "-opt", f"save-dir={d}"]],
        keep=last // 2)
    (metrics, pa, saves), = calls
    with open(os.path.join(d, "cavity-metrics.yaml")) as f:
        on_disk = yaml.safe_load(f)
    ck = load_checkpoint(os.path.join(d, "checkpoint.npz"))
    final = pa.vort.cpu().numpy()
    dofs = pa.mesh.n_nodes * pa.dim
    h5 = os.path.join(d, f"vec-data-{last:05d}.h5")
    h5_equal = None
    if importlib.util.find_spec("h5py") is not None:
        import h5py

        with h5py.File(h5) as f:
            h5_equal = bool(np.array_equal(f["fields/vorticity"][()], final))
    elif os.path.exists(h5):
        fail("13a: an HDF5 file without h5py")
    res = {"velocity_dofs": dofs, "dtype": str(pa.dtype), "steps":
           metrics["steps"], "metrics_on_disk": on_disk["steps"],
           "checkpoint_step": ck["step"], "checkpoint_vort_bitwise":
           bool(np.array_equal(ck["vort"], final)), "h5_vort_bitwise":
           h5_equal, "saves": saves, "stencil_launches": n, "seconds": sec,
           "kle_solves": len(pa.cg_iters), "step_ms": [
               1e3 * (b - a) for a, b in zip(pa.step_marks,
                                             pa.step_marks[1:])]}
    out["cli_cavity"] = res
    print(f"  steps 2-{last} {[round(x, 1) for x in res['step_ms']]} ms "
          f"(with the saves), {res['kle_solves']} KLE solves", flush=True)
    print(f"  {dofs} velocity dofs, {pa.dtype}: steps {metrics['steps']} "
          f"(file {on_disk['steps']}), checkpoint step {ck['step']}, "
          f"checkpoint vorticity bitwise {res['checkpoint_vort_bitwise']}, "
          f"{os.path.basename(h5)} bitwise {h5_equal}, {n} stencil2d "
          "launches, "
          f"{sec:.1f} s", flush=True)
    if (dofs, pa.dtype, tuple(pa.nelem)) != (7442, torch.float64, (30, 30)):
        fail(f"13a: not configs/cavity.yaml's cavity: {dofs} dofs")
    if not (metrics["steps"] == on_disk["steps"] == ck["step"] == last
            and res["checkpoint_vort_bitwise"] and h5_equal is not False
            and n > 0):
        fail("13a: metrics, checkpoint or fields wrong, or no launches")
    legs["13a"] = (n, shapes)

    # the resume from 13a's step-1 checkpoint, kept by cli_probe
    half = last // 2
    ck_half = os.path.join(d, f"checkpoint.npz.{half}")
    if load_checkpoint(ck_half)["step"] != half:
        fail(f"13a: the kept checkpoint is not step {half}'s")
    calls, n, shapes, sec = run_cli_leg(torch, stencil, [
        ["-case", "cavity", "-resume", ck_half, "-max-steps", str(last),
         "-opt", f"save-dir={os.path.join(tmp, '13b-resumed')}"]])
    pb = calls[0][1]
    rel = rel_diff(torch, pb.vort, pa.vort)
    limit = CLI_RESUME_FACTOR * pb.kle_rtol
    res = {"steps": calls[0][0]["steps"], "vort_rel_diff_vs_13a": rel,
           "limit": limit, "bitwise": bool(torch.equal(pb.vort, pa.vort)),
           "stencil_launches": n, "seconds": sec}
    out["cli_cavity_resume"] = res
    print(f"  resumed at step {half} to step {res['steps']}: vorticity vs 13a "
          f"{rel:.3e} (limit {limit:g}), bitwise {res['bitwise']}, {n} "
          f"stencil2d launches, {sec:.1f} s", flush=True)
    if res["steps"] != last or not rel <= limit:
        fail(f"13b: resumed cavity vs 13a {rel:.3e} > {limit:g}")
    legs["13b"] = (n, shapes)

    d1, d2 = os.path.join(tmp, "13c"), os.path.join(tmp, "13c-resumed")
    cfg = os.path.join(tmp, "cavity384.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(cavity_config(384), f)
    common = ["-config", cfg, "-case", "cavity", "-dtype", "float32"]
    calls, n, shapes, sec = run_cli_leg(torch, stencil, [
        common + ["-max-steps", "3", "-opt", "save-n-steps=2", "-opt",
                  f"save-dir={d1}"],
        common + ["-resume", os.path.join(d1, "checkpoint.npz"),
                  "-max-steps", "3", "-opt", f"save-dir={d2}"]])
    (_, pc, saves), (_, pr, saves_r) = calls
    marks = pc.step_marks
    step_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    save_s = sum(s[2] for s in saves if s[1] > 1)
    rel = rel_diff(torch, pr.vort, pc.vort)
    rel3 = rel_diff(torch, pc.vort, base_vort)
    _, dtypes = launch_split(torch, stencil.KERNEL, shapes)
    res = {"velocity_dofs": pc.mesh.n_nodes * pc.dim, "steps": len(marks),
           "step_ms": step_ms, "saves": saves, "resume_saves": saves_r,
           "ms_per_step_excl_saves": (sum(step_ms) - 1e3 * save_s)
           / len(step_ms),
           "resume_vort_rel_diff": rel, "vs_phase3_rel_diff": rel3,
           "vs_phase3_bitwise": bool(torch.equal(pc.vort, base_vort)),
           "stencil_launches": n, "launches_by_dtype": dtypes,
           "seconds": sec}
    out["cli_cavity384"] = res
    print(f"  {res['velocity_dofs']} velocity dofs, float32: steps 1-2, "
          f"2-3 {step_ms[0]:.1f}, {step_ms[1]:.1f} ms; saves "
          + ", ".join(f"{k} at step {st} {t:.3f} s" for k, st, t in saves)
          + f"; {res['ms_per_step_excl_saves']:.1f} ms/step without them",
          flush=True)
    print(f"  resumed at step 2: vorticity vs uninterrupted {rel:.3e}; "
          f"uninterrupted vs phase 3 {rel3:.3e} (bitwise "
          f"{res['vs_phase3_bitwise']}), resume limit {WS_LIMIT:g}; "
          f"stencil2d launches {dtypes}, {sec:.1f} s", flush=True)
    if len(marks) != 3 or not rel <= WS_LIMIT:
        fail("13c: not 3 steps, or the resumed vorticity past the limit")
    if not res["vs_phase3_bitwise"]:
        fail(f"13c: the CLI's run is not phase 3's bit for bit ({rel3:.3e})")
    if dtypes["float64"] or not dtypes["float32"]:
        fail(f"13c: stencil2d launches by dtype {dtypes}")
    legs["13c"] = (n, shapes)
    return legs


def cli_other_legs(torch, stencil, tmp, out):
    """13d-13f; returns the legs' (launches, logged shapes)."""
    import yaml

    from pynama_tpu_torch.cases.uniform import UniformFlowProblem

    legs = {}
    d1, d2, d3 = (os.path.join(tmp, k) for k in ("13d", "13d-2",
                                                "13d-resumed"))
    calls, n, shapes, sec = run_cli_leg(torch, stencil, [
        ["-case", "ibm-static", "-max-steps", "3", "-opt", "save-n-steps=1",
         "-opt", f"save-dir={d1}"],
        ["-case", "ibm-static", "-max-steps", "2", "-opt", "save-n-steps=1",
         "-opt", f"save-dir={d2}"],
        ["-case", "ibm-static", "-resume", os.path.join(d2, "checkpoint.npz"),
         "-max-steps", "3", "-opt", f"save-dir={d3}"]])
    m, mr = calls[0][0], calls[2][0]
    with open(os.path.join(d1, "ibm-static-metrics.yaml")) as f:
        on_disk = yaml.safe_load(f)
    keys = ("cd", "cl", "strouhal")
    rel = max(abs(a - b) / abs(b) for a, b in zip(mr["cd"], m["cd"]))
    res = {"steps": [m["steps"], mr["steps"]], "cd": m["cd"],
           "cd_resumed": mr["cd"], "cd_rel_diff": rel, "cl": m["cl"],
           "strouhal": m["strouhal"], "stencil_launches": n,
           "seconds": sec}
    out["cli_ibm"] = res
    print(f"  cd {m['cd']}, resumed {mr['cd']}: rel diff {rel:.3e} (limit "
          f"{IBM_CD_LIMIT:g}); strouhal {m['strouhal']}; {n} stencil2d "
          f"launches, {sec:.1f} s", flush=True)
    if not all(k in m and k in on_disk for k in keys) or \
            len(mr["cd"]) != len(m["cd"]) or m["steps"] != 3:
        fail("13d: metrics without cd, cl or strouhal, or short histories")
    if not rel <= IBM_CD_LIMIT:
        fail(f"13d: resumed cd history vs uninterrupted {rel:.3e}")
    legs["13d"] = (n, shapes)

    d = os.path.join(tmp, "13e")
    calls, n, shapes, sec = run_cli_leg(torch, stencil, [
        ["-case", "uniform", "-max-steps", "1", "-opt", "kle-solver=gmres",
         "-opt", "multigrid=false", "-opt", f"save-dir={d}"]])
    (m, p, _), = calls
    q = UniformFlowProblem({**p.config, "kle-solver": "cg"},
                           device=p.device).setup()
    u_cg = q.solve_kle(m["final_time"], p.vort)
    rel = rel_diff(torch, p.vel, u_cg)
    limit = GMRES_CG_FACTOR * p.kle_rtol
    res = {"kle_solver": p.kle_solver, "gmres_iters": p.cg_iters,
           "cg_iters": q.cg_iters, "vel_rel_diff_vs_cg": rel, "limit": limit,
           "stencil_launches": n, "seconds": sec}
    out["cli_gmres"] = res
    print(f"  {p.kle_solver}: iterations {p.cg_iters}; velocity vs a CG "
          f"solve ({q.cg_iters} iterations) {rel:.3e} (limit {limit:g}); "
          f"{n} stencil2d launches", flush=True)
    if p.kle_solver != "gmres" or not sum(p.cg_iters) > 0 or \
            not rel <= limit or not n > 0:
        fail("13e: GMRES not used, no iterations, or off the CG solve")
    legs["13e"] = (n, shapes)

    d = os.path.join(tmp, "13f")
    calls, n, shapes, sec = run_cli_leg(torch, stencil, [
        ["-case", "taylor-green", "-test", "kle", "-opt", f"save-dir={d}"],
        ["-case", "taylor-green", "-test", "chartkle", "-opt",
         "time-solver.max-steps=3", "-opt", f"save-dir={d}"]])
    errs, last = calls[0][0]["errors"], calls[1][0]
    rels = [abs(a - b) / b for a, b in zip(errs, REF_KLE_ERRORS)]
    with open("chartkle-taylor-green.yaml") as f:
        hist = yaml.safe_load(f)
    res = {"errors": errs, "rel_diff_vs_reference": rels,
           "chartkle_last": last, "chartkle_steps": hist["step"],
           "stencil_launches": n, "seconds": sec}
    out["cli_kle"] = res
    print(f"  -test kle errors {[f'{e:.3e}' for e in errs]}, max rel diff "
          f"vs the reference's {max(rels):.3e} (limit {KLE_ERR_RTOL:g}); "
          f"-test chartkle {last}; {n} stencil2d launches", flush=True)
    if len(errs) != len(REF_KLE_ERRORS) or not max(rels) <= KLE_ERR_RTOL \
            or any(b >= a for a, b in zip(errs, errs[1:])):
        fail("13f: -test kle errors off the reference's, or not falling")
    if hist["step"] != [1, 2, 3] or not math.isfinite(last["error2"]):
        fail("13f: -test chartkle did not take 3 finite steps")
    legs["13f"] = (n, shapes)
    return legs


def phase_cli_legs(torch, stencil, phase, base_vort, checked, out):
    """Phase 13 (see the module's docstring); ``base_vort`` is phase 3's
    final vorticity, ``checked`` the (x, W, dtype) shapes earlier phases
    held against the plain version. Returns stencil2d's launches by leg
    and 13g's rows."""
    from collections import Counter

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("yaml", "h5py", "matplotlib")}
    out["cli_python"] = have
    print("[13] the command line; installed: " + ", ".join(
        f"{m} {'yes' if v else 'no'}" for m, v in have.items()), flush=True)
    legs = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            legs.update(phase(
                "cli_cavity", "[13a-c] run_case: the cavity, its resume, "
                "and the 384x384 cavity",
                lambda: cli_cavity_legs(torch, stencil, tmp, base_vort,
                                        out)))
            legs.update(phase(
                "cli_other", "[13d-f] run_case: ibm-static and its resume, "
                "uniform with GMRES, taylor-green -test kle and chartkle",
                lambda: cli_other_legs(torch, stencil, tmp, out)))
        finally:
            os.chdir(cwd)
    logged = Counter()
    for _, shapes in legs.values():
        logged.update(shapes)
    new = Counter({s: c for s, c in logged.items() if s not in checked})
    rows = phase("cli_kernels",
                 "[13g] stencil2d vs plain version at the CLI legs' new "
                 "shapes",
                 lambda: phase_logged_kernels(torch, stencil, stencil.KERNEL,
                                              new, sum(new.values()),
                                              "cli_kernels", out))
    return {leg: n for leg, (n, _) in legs.items()}, rows


# ----------------------------------------------------------------------
# phase 14: unstructured Gmsh meshes (no kernel: ElementOps and Schwarz)
# ----------------------------------------------------------------------
GMSH_CAVITY_N = 128        # 14a: quads per side, jittered by 0.15 / N
GMSH_TG_N = 16             # 14b: hexes per side, jittered by 0.03 / N
GMSH_CHANNEL = (12, 12, 30)  # 14c: channel3d's box, cut from 32x32x80
GMSH_CPU_LIMIT = 1e-8      # 14d: card vs CPU vorticity / RHS, relative
GMSH_CPU_CHECK_N = 32      # 14d: the CPU initial RHS's quads per side
# 14b: the velocity's relative error against the exact field after 3
# steps: the port's CPU run of the same config gave GMSH_TG_CPU_ERR
# (gmsh_tg_cpu_error(), a few minutes; its last digits follow the host's
# thread count); the card may be 5% above it
GMSH_TG_CPU_ERR = 0.1250127793413192
GMSH_TG_EXACT_LIMIT = 1.05 * GMSH_TG_CPU_ERR


def box_corner_mesh(nx, ny, distort=0.0, seed=0):
    """Corner points + ccw quads of an nx x ny unit box, interior corners
    jittered by uniform(-distort, distort) (tests/test_unstructured.py's
    helper, copied)."""
    import numpy as np

    xs = np.linspace(0, 1, nx + 1)
    ys = np.linspace(0, 1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
    if distort:
        rng = np.random.default_rng(seed)
        interior = ((pts[:, 0] > 0) & (pts[:, 0] < 1) & (pts[:, 1] > 0)
                    & (pts[:, 1] < 1))
        pts[interior] += rng.uniform(-distort, distort,
                                     (interior.sum(), 2))
    W = nx + 1
    v0 = (np.arange(ny)[:, None] * W + np.arange(nx)[None, :]).reshape(-1)
    quads = np.stack([v0, v0 + 1, v0 + 1 + W, v0 + W], axis=1)
    return pts, quads.astype(np.int64)


def box_hex_mesh(nx, ny, nz, distort=0.0, seed=0, upper=(1.0, 1.0, 1.0)):
    """Corner points + gmsh-ordered hexes of an nx x ny x nz box (the
    unit box's helper of tests/test_unstructured.py, copied, then scaled
    to ``upper``)."""
    import numpy as np

    xs, ys, zs = (np.linspace(0, 1, k + 1) for k in (nx, ny, nz))
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    pts = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=1)
    if distort:
        rng = np.random.default_rng(seed)
        interior = np.all((pts > 0) & (pts < 1), axis=1)
        pts[interior] += rng.uniform(-distort, distort,
                                     (interior.sum(), 3))
    pts = pts * np.asarray(upper)
    W, H = nx + 1, (nx + 1) * (ny + 1)
    v0 = (np.arange(nz)[:, None, None] * H + np.arange(ny)[None, :, None] * W
          + np.arange(nx)[None, None, :]).reshape(-1)
    hexes = np.stack([v0, v0 + 1, v0 + 1 + W, v0 + W, v0 + H, v0 + 1 + H,
                      v0 + 1 + W + H, v0 + W + H], axis=1)
    return pts, hexes.astype(np.int64)


def write_msh22(path, pts, cells, etype, walls=None):
    """A Gmsh v2.2 ASCII file of ``cells`` (gmsh type 3 quads or 5
    hexes). With ``walls`` (quads on the x = 0 plane of a hex mesh) they
    are the physical surface "left" and the hexes the volume "fluid", as
    tests/test_unstructured.py's _write_hex_msh writes them; without,
    nothing is named."""
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        if walls is not None:
            f.write('$PhysicalNames\n2\n2 10 "left"\n3 20 "fluid"\n'
                    "$EndPhysicalNames\n")
        f.write(f"$Nodes\n{len(pts)}\n")
        for i, p in enumerate(pts):
            z = p[2] if len(p) > 2 else 0.0
            f.write(f"{i + 1} {p[0]:.17g} {p[1]:.17g} {z:.17g}\n")
        f.write("$EndNodes\n")
        walls = [] if walls is None else walls
        f.write(f"$Elements\n{len(cells) + len(walls)}\n")
        for i, c in enumerate(cells):
            f.write(f"{i + 1} {etype} 2 20 1 "
                    + " ".join(str(v + 1) for v in c) + "\n")
        for i, q in enumerate(walls):
            f.write(f"{len(cells) + i + 1} 3 2 10 2 "
                    + " ".join(str(v + 1) for v in q) + "\n")
        f.write("$EndElements\n")


def left_wall_quads(nx, ny, nz):
    """The x = 0 boundary quads of box_hex_mesh(nx, ny, nz)."""
    W, H = nx + 1, (nx + 1) * (ny + 1)
    return [[v0, v0 + W, v0 + W + H, v0 + H]
            for v0 in (ez * H + ey * W for ez in range(nz)
                       for ey in range(ny))]


def gmsh_cavity_config(path, nelem):
    """configs/cavity.yaml's material, boundary conditions and
    time-solver on a Gmsh file of nelem x nelem quads (unnamed: the walls
    come from the geometric fallback), dt0 at the explicit step limit:
    0.4 at 8x8 scaled as h^2 (tests/test_torch_cavity_dt_limit.py). The
    file's dt0 of 0.1 cost 128x128 three rejected attempts (12 KLE solves
    of ~650 CG iterations each) before the first step."""
    import yaml

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "configs", "cavity.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["domain"] = {"ngl": 3, "gmsh-file": path}
    cfg["time-solver"]["dt0"] = 0.4 * (8 / nelem) ** 2
    return cfg


def gmsh_tg_config(path):
    """tests/test_unstructured.py test_gmsh_hex_case_transient's material,
    first step (dt0 0.002) and KLE tolerance at ngl 3 on a Gmsh file; its
    end time 0.02 would end the run after 2 steps, so the end time is 1."""
    return {
        "name": "tg3d-gmsh",
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "domain": {"ngl": 3, "gmsh-file": path},
        "time-solver": {"start-time": 0.0, "end-time": 1.0,
                        "max-steps": 20, "dt0": 0.002},
        "kle-rtol": 1e-11,
    }


def gmsh_tg_cpu_error():
    """14b's run on the CPU: the source of GMSH_TG_CPU_ERR.

        python3 -c "import chip_smoke; print(chip_smoke.gmsh_tg_cpu_error())"
    """
    import torch

    from pynama_tpu_torch.cases.analytic import CustomFuncProblem

    n = GMSH_TG_N
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tg3d.msh")
        pts, hexes = box_hex_mesh(n, n, n, distort=0.03 / n)
        write_msh22(path, pts, hexes, 5)
        p = CustomFuncProblem(gmsh_tg_config(path), case="taylor-green",
                              device="cpu").setup()
    _, t, _ = p.run(max_steps=3)
    vel_e, _ = p.exact_fields(t)
    return rel_diff(torch, p.vel, vel_e.reshape(-1))


def gmsh_run(torch, stencil, p, key, out, steps=3):
    """setup() + run(max_steps=steps) of a Gmsh problem, the launch counts
    set to 0 just before and read just after (this path launches no
    stencil kernel: every count must stay 0); RHS evaluations counted
    (6 an attempt) and the initial RHS's result kept for 14d."""
    from pynama_tpu_torch.mesh.native import have_native

    marks = []
    rhs, first = p.transport_rhs, {}

    def counted(t, vort, aux):
        f, aux_out = rhs(t, vort, aux)
        if not first:
            first.update(f=f.clone(), aux=tuple(a.clone() for a in aux_out)
                         if isinstance(aux_out, tuple) else aux_out.clone(),
                         t=t, iters=list(p.cg_iters))
        first["evals"] = first.get("evals", 0) + 1
        return f, aux_out

    def callback(n, t, dt, vort, vel):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), len(p.cg_iters), first["evals"],
                      dt))

    for k in stencil.LIBRARIES:
        k.reset_counts()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p.setup()
    torch.cuda.synchronize()
    t_setup = time.perf_counter()
    p.transport_rhs = counted
    vort, t, n = p.run(max_steps=steps, callback=callback)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k.name: k.launches for k in stencil.KERNELS.values()}
    if n != steps or len(marks) != steps:
        fail(f"{key}: expected {steps} accepted steps, got {n}")
    if not bool(torch.isfinite(vort).all()):
        fail(f"{key}: final vorticity is not finite")
    if any(launches.values()):
        fail(f"{key}: the Gmsh path launched stencil kernels {launches}")
    starts = [(t_setup, 0, 1)] + [m[:3] for m in marks]
    step_ms = [1e3 * (b[0] - a[0]) for a, b in zip(starts, starts[1:])]
    evals = [b[2] - a[2] for a, b in zip(starts, starts[1:])]
    iters = p.cg_iters
    pcs = {name: {"patches": pc.patches, "n_patches": pc.n_patches,
                  "block_dofs": pc.block_dofs, "coarse_dofs": pc.coarse_dofs}
           for name, pc in p._minv.items()}
    res = {
        "cells": p.mesh.n_cells, "nodes": p.mesh.n_nodes, "ngl": p.ngl,
        "velocity_dofs": p.mesh.n_nodes * p.dim,
        "dtype": str(p.dtype).replace("torch.", ""), "steps": n, "t": t,
        "dt": [m[3] for m in marks],
        "setup_s": t_setup - t0, "setup_split_s": dict(p.setup_s),
        "step_ms": step_ms, "first_step_incl_initial_rhs": True,
        "ms_per_step_2_3": sum(step_ms[1:]) / max(len(step_ms) - 1, 1),
        "attempts_per_step": [e // 6 for e in evals],
        "run_s_incl_final_solve": t_end - t_setup,
        "kle_solves": len(iters), "cg_iters": iters,
        "cg_iters_per_solve": sum(iters) / len(iters),
        "preconditioners": pcs, "native_numbering": have_native(),
        "stencil_launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    out[key] = res
    print(f"  {res['cells']} cells, {res['nodes']} nodes, "
          f"{res['velocity_dofs']} velocity dofs; setup "
          f"{res['setup_s']:.2f} s (" + ", ".join(
              f"{k} {v:.2f}" for k, v in p.setup_s.items())
          + f"); native numbering {res['native_numbering']}", flush=True)
    for name, pc in pcs.items():
        print(f"  {name}: {pc['n_patches']} {pc['patches']} patches of "
              f"{pc['block_dofs']} dofs, coarse dofs {pc['coarse_dofs']}",
              flush=True)
    print(f"  steps {[round(x, 1) for x in step_ms]} ms (step 1 with the "
          f"initial RHS), attempts {res['attempts_per_step']}, dt "
          f"{res['dt']}; {len(iters)} KLE solves, "
          f"{res['cg_iters_per_solve']:.1f} CG iterations per solve (max "
          f"{max(iters)}); peak memory {res['peak_mem_gib']:.2f} GiB; "
          f"stencil launches {launches}", flush=True)
    p.transport_rhs = rhs
    return first


def gmsh_cavity_leg(torch, stencil, tmp, out):
    """14a; returns its problem and the initial RHS's record."""
    from pynama_tpu_torch.cases.cavity import CavityProblem

    t0 = time.perf_counter()
    n = GMSH_CAVITY_N
    path = os.path.join(tmp, "cavity.msh")
    pts, quads = box_corner_mesh(n, n, distort=0.15 / n, seed=1)
    write_msh22(path, pts, quads, 3)
    p = CavityProblem(gmsh_cavity_config(path, n))
    write_s = time.perf_counter() - t0
    first = gmsh_run(torch, stencil, p, "gmsh_cavity", out)
    out["gmsh_cavity"]["write_and_read_s"] = write_s
    return p, first


def gmsh_tg_leg(torch, stencil, tmp, out):
    """14b."""
    from pynama_tpu_torch.cases.analytic import CustomFuncProblem

    n = GMSH_TG_N
    path = os.path.join(tmp, "tg3d.msh")
    pts, hexes = box_hex_mesh(n, n, n, distort=0.03 / n)
    write_msh22(path, pts, hexes, 5)
    p = CustomFuncProblem(gmsh_tg_config(path), case="taylor-green")
    gmsh_run(torch, stencil, p, "gmsh_tg3d", out)
    t = out["gmsh_tg3d"]["t"]
    vel_e, _ = p.exact_fields(t)
    err = rel_diff(torch, p.vel, vel_e.reshape(-1))
    pc = out["gmsh_tg3d"]["preconditioners"]["free_mask"]
    out["gmsh_tg3d"].update(vel_rel_err_vs_exact=err,
                            cpu_vel_rel_err=GMSH_TG_CPU_ERR)
    print(f"  velocity vs exact at t {t:.6g}: {err:.6e} (the CPU run "
          f"{GMSH_TG_CPU_ERR:.6e}, limit {GMSH_TG_EXACT_LIMIT:g})",
          flush=True)
    if pc["patches"] != "element":
        fail("14b: vertex stars fit the guard; the retry to element "
             "blocks was not exercised")
    if not err < GMSH_TG_EXACT_LIMIT:
        fail(f"14b: velocity error vs exact {err:.3e}")


def gmsh_channel_leg(torch, stencil, tmp, out):
    """14c: the documented command through run_case.main."""
    import numpy as np

    nx, ny, nz = GMSH_CHANNEL
    path = os.path.join(tmp, "channel.msh")
    pts, hexes = box_hex_mesh(nx, ny, nz, distort=0.1 / nx, seed=3,
                              upper=(1.0, 1.0, 2.5))
    write_msh22(path, pts, hexes, 5, walls=left_wall_quads(nx, ny, nz))
    d = os.path.join(tmp, "14c")
    calls, n, _, sec = run_cli_leg(torch, stencil, [
        ["-case", "channel3d", "-gmsh", path, "-max-steps", "1",
         "-opt", f"save-dir={d}"]])
    metrics, p, _ = calls[0]
    left = p.mesh.face_nodes.get("left")
    on_plane = left is not None and \
        bool(np.abs(p.mesh.coords[left, 0]).max() <= 1e-12)
    want = (2 * ny + 1) * (2 * nz + 1)
    dev = float((p.vel.reshape(-1, 3) - torch.tensor(
        [1.0, 0.0, 0.0], dtype=p.vel.dtype, device=p.vel.device)).abs().max())
    res = {"hexes": list(GMSH_CHANNEL), "velocity_dofs": p.mesh.n_nodes * 3,
           "steps": metrics["steps"], "seconds": sec,
           "setup_split_s": dict(p.setup_s), "face_names":
           sorted(p.mesh.face_nodes), "left_nodes": 0 if left is None
           else len(left), "left_nodes_expected": want,
           "max_abs_u_minus_uniform": dev, "cg_iters": p.cg_iters,
           "preconditioner": p._minv["free_mask"].patches,
           "stencil_launches": n}
    out["gmsh_channel3d"] = res
    print(f"  {res['velocity_dofs']} velocity dofs, 1 step in {sec:.1f} s "
          f"(setup " + ", ".join(f"{k} {v:.2f}" for k, v in
                                 p.setup_s.items())
          + f"); faces {res['face_names']}, 'left' {res['left_nodes']} "
          f"nodes (want {want}) on x = 0 {on_plane}; max |u - (1,0,0)| "
          f"{dev:.3e}; CG {p.cg_iters}; {res['preconditioner']} patches",
          flush=True)
    if metrics["steps"] != 1 or n != 0:
        fail("14c: not 1 step, or stencil kernels launched")
    if res["face_names"] != ["left"] or res["left_nodes"] != want or \
            not on_plane:
        fail("14c: the named face 'left' is not the x = 0 plane's nodes")
    if not dev <= 1e-6:
        fail(f"14c: the uniform flow is not reproduced: {dev:.3e}")


def gmsh_cpu_leg(torch, tmp, out, p14, first):
    """14d: small Gmsh runs on the card and on the CPU; 14a's initial RHS
    repeated on the card (bit for bit, the same CG iterations), then once
    more under the sync debug mode and the profiler: host syncs, kernel
    launches and device time per CG iteration; then the initial RHS at
    GMSH_CPU_CHECK_N on the CPU against the card's."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from pynama_tpu_torch.cases.analytic import CustomFuncProblem
    from pynama_tpu_torch.cases.cavity import CavityProblem

    c_path, h_path = (os.path.join(tmp, k) for k in ("c8.msh", "h3.msh"))
    pts, quads = box_corner_mesh(8, 8, distort=0.15 / 8, seed=1)
    write_msh22(c_path, pts, quads, 3)
    pts, hexes = box_hex_mesh(3, 3, 3, distort=0.03 / 3)
    write_msh22(h_path, pts, hexes, 5)
    legs = {}
    for name, make, steps in (
            ("cavity_8x8", lambda dev: CavityProblem(
                gmsh_cavity_config(c_path, 8), device=dev), 3),
            ("tg3d_3x3x3", lambda dev: CustomFuncProblem(
                gmsh_tg_config(h_path), case="taylor-green", device=dev), 1)):
        runs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            p = make(dev).setup()
            vort, t, n = p.run(max_steps=steps)
            runs[dev] = (vort.cpu(), t, n, p.cg_iters,
                         time.perf_counter() - t0)
        (vc, tc, nc, ic, sc), (vh, th, nh, ih, sh) = runs["cuda"], runs["cpu"]
        rel = rel_diff(torch, vc, vh)
        legs[name] = {"steps": [nc, nh], "t": [tc, th], "vort_rel_diff": rel,
                      "cg_iters_card": ic, "cg_iters_cpu": ih,
                      "seconds_card": sc, "seconds_cpu": sh}
        print(f"  {name}: steps {nc}/{nh}, setup and run {sc:.1f} s on the "
              f"card, {sh:.1f} s on the CPU; vorticity card vs CPU {rel:.3e} "
              f"(limit {GMSH_CPU_LIMIT:g}); CG card {ic}", flush=True)
        print(f"  {'':{len(name)}}  CG CPU  {ih}", flush=True)
        if nc != steps or nh != steps or not rel <= GMSH_CPU_LIMIT:
            fail(f"14d {name}: card vs CPU {rel:.3e}, steps {nc}/{nh}")

    def repeat():
        k = len(p14.cg_iters)
        f, aux = p14.transport_rhs(first["t"], p14.initial_vorticity(),
                                   p14.zero_vel())
        torch.cuda.synchronize()
        return f, aux, p14.cg_iters[k:]

    want_iters = first["iters"][:2] if len(first["iters"]) >= 2 else None
    f, aux, iters = repeat()
    same = bool(torch.equal(f, first["f"])) and all(
        torch.equal(a, b) for a, b in zip(aux, first["aux"]))
    # once more: host syncs (every synchronizing call warns once) and
    # the profiler's kernels
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            f2, _, iters2 = repeat()
            wall = time.perf_counter() - t0
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    kernels, dev_us = 0, 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if "CUDA" in str(e.device_type) and us > 0:
            kernels += e.count
            dev_us += us
    its = sum(iters2)
    res = {"legs": legs, "repeat_bitwise_equal": same,
           "repeat_cg_iters": iters, "first_cg_iters": want_iters,
           "profiled_repeat_bitwise_equal": bool(torch.equal(f2, f)),
           "profiled_wall_ms": 1e3 * wall, "host_syncs": syncs,
           "kernels": kernels, "device_ms": dev_us / 1e3,
           "cg_iters_profiled": iters2,
           "host_syncs_per_iteration": syncs / max(its, 1),
           "kernels_per_iteration": kernels / max(its, 1),
           "device_busy_share": dev_us / 1e3 / (1e3 * wall)}
    out["gmsh_card_vs_cpu"] = res
    print(f"  14a's initial RHS again: bitwise equal {same}, CG {iters} "
          f"(14a {want_iters}); under the sync debug mode and the profiler: "
          f"{syncs} host syncs and {kernels} kernels over {its} CG "
          f"iterations ({res['host_syncs_per_iteration']:.2f} and "
          f"{res['kernels_per_iteration']:.1f} an iteration), device "
          f"{res['device_ms']:.1f} ms of {res['profiled_wall_ms']:.1f} ms "
          f"wall ({100 * res['device_busy_share']:.1f}% busy, profiler on)",
          flush=True)
    if not same or iters != want_iters or not res[
            "profiled_repeat_bitwise_equal"]:
        fail("14d: a repeat of 14a's first solves is not bitwise equal or "
             "takes other CG iterations")
    gmsh_sized_cpu(torch, tmp, res)


def gmsh_sized_cpu(torch, tmp, res):
    """The initial RHS (its first two KLE solves, Schwarz-CG) of
    14a's cavity at GMSH_CPU_CHECK_N x GMSH_CPU_CHECK_N quads, on the card
    and on a problem set up from the same file with device="cpu": the
    RHS and both velocities within GMSH_CPU_LIMIT. At 14a's own size until
    phase 17 was added and at 64 until 12g was; each cut to make room."""
    from pynama_tpu_torch.cases.cavity import CavityProblem

    def tup(a):
        return a if isinstance(a, tuple) else (a,)

    n = GMSH_CPU_CHECK_N
    path = os.path.join(tmp, f"cavity{n}.msh")
    pts, quads = box_corner_mesh(n, n, distort=0.15 / n, seed=1)
    write_msh22(path, pts, quads, 3)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = CavityProblem(gmsh_cavity_config(path, n), device=dev).setup()
        t1 = time.perf_counter()
        f, aux = p.transport_rhs(p.t_start, p.initial_vorticity(),
                                 p.zero_vel())
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = ([f.cpu()] + [a.cpu() for a in tup(aux)], p.cg_iters,
                     t1 - t0, time.perf_counter() - t1)
    rels = [rel_diff(torch, a, b)
            for a, b in zip(runs["cuda"][0], runs["cpu"][0])]
    res.update(sized_cpu_nelem=n, sized_cpu_rel_diff=rels,
               sized_cpu_cg_iters=runs["cpu"][1],
               sized_card_cg_iters=runs["cuda"][1],
               sized_cpu_setup_s=runs["cpu"][2], sized_cpu_rhs_s=runs["cpu"][3])
    print(f"  the initial RHS at {n}x{n} ({p.mesh.n_nodes * p.dim} velocity "
          f"dofs) on the CPU (setup {runs['cpu'][2]:.1f} s, RHS "
          f"{runs['cpu'][3]:.1f} s) vs the card: RHS and velocities "
          f"{', '.join(f'{r:.3e}' for r in rels)} (limit "
          f"{GMSH_CPU_LIMIT:g}); CG CPU {runs['cpu'][1]}, card "
          f"{runs['cuda'][1]}", flush=True)
    if not max(rels) <= GMSH_CPU_LIMIT:
        fail(f"14d: the {n}x{n} initial RHS on the CPU is {max(rels):.3e} "
             "off the card's")


def phase_gmsh_legs(torch, stencil, phase, out):
    """Phase 14 (see the module's docstring)."""
    with tempfile.TemporaryDirectory() as tmp:
        p14, first = phase("gmsh_cavity",
                           f"[14a] Gmsh cavity: {GMSH_CAVITY_N}x"
                           f"{GMSH_CAVITY_N} distorted quads, 3 steps",
                           lambda: gmsh_cavity_leg(torch, stencil, tmp, out))
        phase("gmsh_tg3d", f"[14b] Gmsh 3D Taylor-Green: {GMSH_TG_N}^3 "
              "distorted hexes, 3 steps",
              lambda: gmsh_tg_leg(torch, stencil, tmp, out))
        phase("gmsh_channel3d", "[14c] run_case -case channel3d -gmsh: "
              + "x".join(map(str, GMSH_CHANNEL)) + " hexes, 1 step",
              lambda: gmsh_channel_leg(torch, stencil, tmp, out))
        phase("gmsh_card_vs_cpu", "[14d] Gmsh runs on the card vs the CPU; "
              "14a's first solves repeated; a "
              f"{GMSH_CPU_CHECK_N}x{GMSH_CPU_CHECK_N} initial RHS on both",
              lambda: gmsh_cpu_leg(torch, tmp, out, p14, first))


# ----------------------------------------------------------------------
# phase 15: immersed bodies on Gmsh domains (no kernel: the Gmsh path and
# the couplings are plain torch)
# ----------------------------------------------------------------------
GRADING = 1.1  # the most an element is wider than its inner neighbour
# 15a: the Re-40 geometry; the core at the 144x96 box's element width
IBM_GMSH_RE40 = {"core": ((-1.5, 4.5), (-1.5, 1.5)), "h-min": "1/8"}
# 15b: ibm-dynamic.yaml's geometry; the core at its 48x48 element width
IBM_GMSH_DYN = {"core": ((-1.5, 1.5), (-1.5, 1.5)), "h-min": "1/6"}
IBM_GMSH_STEPS = 3
# 15d: the Gmsh coupling's windows against the box coupling's, the same
# points and nodes: node -> weight, absolute
IBM_GMSH_WINDOW_LIMIT = 1e-14
# 15d: the cd history on the 48x48 Gmsh box against 12a's on the box
# mesh, relative per step. The Schwarz-CG and the multigrid-CG KLE
# solves agree only to kle-rtol (1e-10), and cd divides the flux by dt:
# the CPU run of the same pair (ibm_gmsh_box_cd_cpu()) gave
# IBM_GMSH_BOX_CD_CPU; the bound is 100 times it
IBM_GMSH_BOX_CD_CPU = 2.8893521544552812e-09
IBM_GMSH_BOX_CD_LIMIT = 100 * IBM_GMSH_BOX_CD_CPU


def graded_axis(lo, hi, core_lo, core_hi, width, growth=GRADING):
    """Element edges along one axis: uniform at ``width`` over [core_lo,
    core_hi]; outside it, out to lo and to hi, the fewest elements whose
    widths grow from ``width`` by ``growth`` an element reach the
    boundary, and their common ratio is then lowered (to r in [1,
    growth], by bisection) so that the last ends on it: no element is
    narrower than ``width`` nor more than ``growth`` times its inner
    neighbour."""
    import numpy as np

    n = int(round((core_hi - core_lo) / width))
    core = core_lo + width * np.arange(n + 1)

    def widths(r, m):
        return width * r ** np.arange(1, m + 1)

    def side(d):
        if d <= 0:
            return np.zeros(0)
        m = 1
        while widths(growth, m).sum() < d:
            m += 1
        lo_r, hi_r = 1.0, growth
        if widths(1.0, m).sum() > d:  # a gap under m widths: uniform
            w = np.full(m, d / m)
        else:
            for _ in range(200):
                mid = 0.5 * (lo_r + hi_r)
                lo_r, hi_r = ((mid, hi_r) if widths(mid, m).sum() < d
                              else (lo_r, mid))
            w = widths(hi_r, m)
        edges = np.cumsum(w)
        edges[-1] = d
        return edges

    return np.concatenate([core_lo - side(core_lo - lo)[::-1], core,
                           core_hi + side(hi - core_hi)])


def tensor_quad_mesh(xs, ys):
    """Corner points and ccw quads of the tensor-product grid xs x ys
    (box_corner_mesh's numbering)."""
    import numpy as np

    X, Y = np.meshgrid(xs, ys, indexing="xy")
    pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
    W = len(xs)
    v0 = (np.arange(len(ys) - 1)[:, None] * W
          + np.arange(W - 1)[None, :]).reshape(-1)
    return pts, np.stack([v0, v0 + 1, v0 + 1 + W, v0 + W], axis=1)


def ibm_gmsh_mesh(path, lower, upper, core, h_min):
    """A graded Gmsh v2.2 file around ``core`` ((x lo, x hi), (y lo,
    y hi)) at element width h_min inside it; returns (quads per axis)."""
    axes = [graded_axis(lower[i], upper[i], core[i][0], core[i][1], h_min)
            for i in range(2)]
    pts, quads = tensor_quad_mesh(*axes)
    write_msh22(path, pts, quads, 3)
    return [len(a) - 1 for a in axes]


def ibm_gmsh_config(cfg, path, h_min):
    """An IBM config on the Gmsh file ``path``, 'h-min' h_min (a
    string, as in a YAML file)."""
    return {**cfg, "domain": {"ngl": 3, "gmsh-file": path, "h-min": h_min}}


def ibm_small_gmsh(tmp, kind):
    """15c's config: ibm_small_config's material and body on a uniform
    12x12 Gmsh box of [-3,3]^2, 'h-min' 6/12; the body moving for
    ``kind`` "dynamic"."""
    import numpy as np

    path = os.path.join(tmp, "ibm12.msh")
    if not os.path.exists(path):
        write_msh22(path, *tensor_quad_mesh(np.linspace(-3, 3, 13),
                                            np.linspace(-3, 3, 13)), 3)
    cfg = ibm_gmsh_config(ibm_small_config(12), path, "6/12")
    if kind == "dynamic":
        cfg["bodies"] = [{**cfg["bodies"][0], "vel": "dynamic"}]
    return cfg


def ibm_box_gmsh(tmp):
    """15d's config: configs/ibm-static.yaml with its 48x48 box of
    [-3,3]^2 written as a uniform Gmsh file, 'h-min' 6/48."""
    import numpy as np

    path = os.path.join(tmp, "ibm48.msh")
    axis = np.linspace(-3, 3, 49)
    write_msh22(path, *tensor_quad_mesh(axis, axis), 3)
    return ibm_gmsh_config(IBM_CONFIGS["ibm-static"], path, "6/48")


def ibm_gmsh_box_cd_cpu():
    """15d's pair on the CPU, 3 steps each: the source of
    IBM_GMSH_BOX_CD_CPU (the largest relative difference of the cd
    histories).

        python3 -c "import chip_smoke; print(chip_smoke.ibm_gmsh_box_cd_cpu())"
    """
    from pynama_tpu_torch.cases.immersed import ImmersedBoundaryProblem

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for cfg in (IBM_CONFIGS["ibm-static"], ibm_box_gmsh(tmp)):
            p = ImmersedBoundaryProblem(cfg, device="cpu").setup()
            p.run(max_steps=IBM_GMSH_STEPS)
            runs.append(p.cd_history)
    return max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(*runs))


def ibm_gmsh_run(torch, stencil, p, key, out, coupling_cls,
                 steps=IBM_GMSH_STEPS):
    """setup() + run(max_steps=steps) of an IBM problem on a Gmsh domain,
    the launch counts set to 0 just before and read just after (0 they
    must stay); fails unless the coupling is ``coupling_cls``, the
    vorticity finite, the slip max |H u - U_body| below SLIP_LIMIT after
    every step, the mesh's boundary nodes (its own numbering) at the far
    field within LAYOUT_LIMIT u_ref, the last cd finite and positive, and
    a moving body moved. Returns (the problem, the first post-step's
    arguments, results and iterations) for 15c's repeat."""
    marks, first = [], {}
    post = p._post_step

    def recorded(*args):
        k, kf = len(p.cg_iters), len(p.coupling.cg_iters)
        if first:
            return post(*args)
        saved = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        res = post(*args)
        first.update(args=saved, out=tuple(r.clone() for r in res),
                     iters=p.cg_iters[k:], flux=p.coupling.cg_iters[kf:])
        return res

    def callback(n, t, dt, vort, vel):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), len(p.cg_iters),
                      len(p.coupling.cg_iters), t, vel.reshape(-1).clone()))

    for k in stencil.LIBRARIES:
        k.reset_counts()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p.setup()
    torch.cuda.synchronize()
    t_setup = time.perf_counter()
    p._post_step = recorded
    vort, t, n = p.run(max_steps=steps, callback=callback)
    torch.cuda.synchronize()
    p._post_step = post
    launches = {k.name: k.launches for k in stencil.KERNELS.values()}
    if not isinstance(p.coupling, coupling_cls):
        fail(f"{key}: the coupling is {type(p.coupling).__name__}, not "
             f"{coupling_cls.__name__}")
    if n != steps or len(marks) != steps:
        fail(f"{key}: expected {steps} accepted steps, got {n}")
    if not bool(torch.isfinite(vort).all()):
        fail(f"{key}: final vorticity is not finite")
    if any(launches.values()):
        fail(f"{key}: the Gmsh path launched stencil kernels {launches}")
    slips = []
    for m in marks:
        X, Ub = p._body_state(m[3])
        nodes, w = p.coupling.windows(X)
        slips.append(float((p.coupling.interp(m[4], nodes, w) - Ub)
                           .abs().max()))
    u_inf = torch.as_tensor(p.cte_value, dtype=p.dtype, device=p.device)
    dev = (p.vel.reshape(-1, 2) - u_inf).abs().amax(dim=1)
    bn = torch.as_tensor(p.mesh.boundary_nodes.astype("int64"),
                         device=p.device)
    edge, field = float(dev[bn].max()), float(dev.max())
    cd = p.cd_history[-1][0]
    moved = float(abs(p.body.coords_at(t) - p.body.coords_at(0.0)).max())
    starts = [(t_setup, 0, 0)] + [m[:3] for m in marks]
    step_ms = [1e3 * (b[0] - a[0]) for a, b in zip(starts, starts[1:])]
    flux = p.coupling.cg_iters
    res = {
        "coupling": type(p.coupling).__name__, "cells": p.mesh.n_cells,
        "nodes": p.mesh.n_nodes, "velocity_dofs": p.mesh.n_nodes * p.dim,
        "lagrange_points": p.body.n_nodes, "h": p.h, "steps": n, "t": t,
        "dt_history": p.dt_history, "setup_s": t_setup - t0,
        "setup_split_s": {**p.setup_s, "coupling": p.coupling_s},
        "step_ms": step_ms, "first_step_incl_initial_post_step": True,
        "ms_per_step_2_3": sum(step_ms[1:]) / max(len(step_ms) - 1, 1),
        "kle_solves": len(p.cg_iters), "cg_iters": list(p.cg_iters),
        "cg_iters_per_solve": sum(p.cg_iters) / len(p.cg_iters),
        "flux_cg_iters": list(flux),
        "flux_cg_iters_per_post_step": sum(flux) / len(flux),
        "cd_history": p.cd_history, "cl_history": p.cl_history,
        "slip_per_step": slips, "boundary_minus_far_field": edge,
        "max_minus_far_field": field, "body_moved": moved,
        "stencil_launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    out[key] = res
    print(f"  {res['coupling']}; {res['cells']} cells, {res['nodes']} "
          f"nodes, {res['velocity_dofs']} velocity dofs, "
          f"{res['lagrange_points']} Lagrange points at h {p.h:.6g}; setup "
          f"{res['setup_s']:.2f} s (" + ", ".join(
              f"{k} {v:.2f}" for k, v in res["setup_split_s"].items())
          + ")", flush=True)
    print(f"  steps {[round(x, 1) for x in step_ms]} ms (step 1 with the "
          f"initial post-step), dt {p.dt_history}; {len(p.cg_iters)} KLE "
          f"solves, {res['cg_iters_per_solve']:.1f} CG iterations a solve "
          f"(max {max(p.cg_iters)}); flux CG {flux}; peak "
          f"{res['peak_mem_gib']:.2f} GiB; stencil launches {launches}",
          flush=True)
    print(f"  cd {[c[0] for c in p.cd_history]}, cl "
          f"{[c[0] for c in p.cl_history]}; slip per step "
          + ", ".join(f"{x:.3e}" for x in slips)
          + f" (limit {SLIP_LIMIT:g}); boundary max |u - u_inf| {edge:.3e} "
          f"(limit {LAYOUT_LIMIT:g} u_ref), over the field {field:.3e}; "
          f"body moved {moved:.4g}", flush=True)
    if not max(slips) < SLIP_LIMIT:
        fail(f"{key}: slip at the body {max(slips):.3e}")
    if not edge <= LAYOUT_LIMIT * p.u_ref or not field > 0.1 * p.u_ref:
        fail(f"{key}: boundary nodes vs the far field {edge:.3e}, field "
             f"{field:.3e}")
    if not (math.isfinite(cd) and cd > 0):
        fail(f"{key}: last cd {cd}")
    if p.body.is_moving and not moved > 0:
        fail(f"{key}: the body did not move")
    return p, first


def ibm_gmsh_leg(torch, stencil, tmp, out, key, cfg, spec, cls,
                 coupling_cls):
    """15a or 15b: the graded mesh of ``spec`` over cfg's box domain."""
    from pynama_tpu_torch.cases.base import _eval_scalar

    box = cfg["domain"]["box-mesh"]
    path = os.path.join(tmp, f"{key}.msh")
    quads = ibm_gmsh_mesh(path, box["lower"], box["upper"], spec["core"],
                          _eval_scalar(spec["h-min"]))
    p = cls(ibm_gmsh_config(cfg, path, spec["h-min"]))
    res = ibm_gmsh_run(torch, stencil, p, key, out, coupling_cls)
    out[key].update(quads_per_axis=quads, core=spec["core"],
                    h_min=spec["h-min"])
    print(f"  graded mesh {quads[0]}x{quads[1]} quads, core "
          f"{spec['core']} at h-min {spec['h-min']}", flush=True)
    return res


def ibm_gmsh_card_vs_cpu(torch, tmp, out, held):
    """15c: the 12x12 Gmsh box, static and moving, 2 steps on the card
    and on the CPU (vorticity within GMSH_CPU_LIMIT, the KLE and flux CG
    lists equal); then 15a's and 15b's first post-steps again on the
    card: bitwise equal, with equal iterations."""
    from pynama_tpu_torch.cases.immersed import (
        ImmersedBoundaryDynamicProblem, ImmersedBoundaryProblem)

    res = {}
    for kind, cls in (("static", ImmersedBoundaryProblem),
                      ("dynamic", ImmersedBoundaryDynamicProblem)):
        runs = {}
        for dev in ("cuda", "cpu"):
            p = cls(ibm_small_gmsh(tmp, kind), device=dev).setup()
            vort, t, n = p.run(max_steps=2)
            runs[dev] = (vort.cpu(), t, n, p.cg_iters, p.coupling.cg_iters)
        (vc, tc, nc, ic, fc), (vh, th, nh, ih, fh) = runs["cuda"], runs["cpu"]
        rel = rel_diff(torch, vc, vh)
        res[kind] = {"steps": [nc, nh], "t": [tc, th], "vort_rel_diff": rel,
                     "cg_iters_card": ic, "cg_iters_cpu": ih,
                     "flux_cg_iters_card": fc, "flux_cg_iters_cpu": fh}
        print(f"  12x12 {kind}: steps {nc}/{nh}, vorticity card vs CPU "
              f"{rel:.3e} (limit {GMSH_CPU_LIMIT:g}); KLE CG lists equal "
              f"{ic == ih}, flux CG card {fc} CPU {fh}", flush=True)
        if nc != 2 or nh != 2 or not rel <= GMSH_CPU_LIMIT or ic != ih \
                or fc != fh:
            fail(f"15c {kind}: card vs CPU {rel:.3e}, steps {nc}/{nh}, "
                 f"CG {ic} / {ih}, flux CG {fc} / {fh}")
    for key in ("ibm_gmsh_re40", "ibm_gmsh_dynamic"):
        p, first = held.pop(key)
        k, kf = len(p.cg_iters), len(p.coupling.cg_iters)
        again = p._post_step(*first["args"])
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a, b))
                   for a, b in zip(again, first["out"]))
        iters, flux = p.cg_iters[k:], p.coupling.cg_iters[kf:]
        res[key + "_repeat"] = {
            "bitwise_equal": same, "cg_iters": iters,
            "first_cg_iters": first["iters"], "flux_cg_iters": flux,
            "first_flux_cg_iters": first["flux"]}
        print(f"  {key}'s first post-step again: bitwise equal {same}, KLE "
              f"CG {iters} (first {first['iters']}), flux CG {flux} (first "
              f"{first['flux']})", flush=True)
        if not same or iters != first["iters"] or flux != first["flux"]:
            fail(f"15c: {key}'s first post-step is not repeated bit for bit")
    out["ibm_gmsh_card_vs_cpu"] = res


def ibm_gmsh_box_leg(torch, stencil, tmp, out):
    """15d: ibm-static.yaml's 48x48 box as a uniform Gmsh file, 3 steps;
    UnstructuredIBMCoupling's windows against IBMCoupling's on 12a's box
    mesh as sparse maps (node -> weight, box ids mapped to the Gmsh
    mesh's by coordinates) within IBM_GMSH_WINDOW_LIMIT; the slip and
    the cd history against 12a's record (no second box run)."""
    import numpy as np

    from pynama_tpu_torch.cases.immersed import ImmersedBoundaryProblem
    from pynama_tpu_torch.ibm.coupling import (IBMCoupling,
                                               UnstructuredIBMCoupling)
    from pynama_tpu_torch.mesh.structured import BoxMesh

    p = ImmersedBoundaryProblem(ibm_box_gmsh(tmp))
    ibm_gmsh_run(torch, stencil, p, "ibm_gmsh_box", out,
                 UnstructuredIBMCoupling)
    box_cfg = IBM_CONFIGS["ibm-static"]["domain"]
    b = box_cfg["box-mesh"]
    box = BoxMesh(nelem=tuple(b["nelem"]), lower=tuple(b["lower"]),
                  upper=tuple(b["upper"]), ngl=box_cfg["ngl"])
    X, _ = p._body_state(0.0)
    cb = IBMCoupling(box, p.body.dl)
    nb, wb = (a.cpu().numpy() for a in cb.windows(X))
    nu, wu = (a.cpu().numpy() for a in p.coupling.windows(None))
    # box node -> Gmsh node, both keyed by their lattice position
    h = cb.h
    bc = np.asarray(box.coords)
    uc = np.asarray(p.mesh.coords)[:, :2]
    key_b = np.rint((bc - bc.min(axis=0)) / h).astype(np.int64)
    key_u = np.rint((uc - uc.min(axis=0)) / h).astype(np.int64)
    npx = int(key_b[:, 0].max()) + 1
    g_of_b = np.empty(len(bc), dtype=np.int64)
    g_of_b[np.argsort(key_b[:, 1] * npx + key_b[:, 0])] = np.argsort(
        key_u[:, 1] * npx + key_u[:, 0])
    L = len(wb)
    dense_b = np.zeros((L, len(uc)))
    dense_u = np.zeros((L, len(uc)))
    np.add.at(dense_b, (np.repeat(np.arange(L), nb.shape[1]),
                        g_of_b[nb.reshape(-1)]), wb.reshape(-1))
    np.add.at(dense_u, (np.repeat(np.arange(L), nu.shape[1]),
                        nu.reshape(-1)), wu.reshape(-1))
    win = float(np.abs(dense_b - dense_u).max())
    box_rec, rec = out["ibm_static"], out["ibm_gmsh_box"]
    cds = [c[0] for c in rec["cd_history"]]
    box_cds = [c[0] for c in box_rec["cd_history"]]
    cd_rel = max(abs(a - b) / abs(b) for a, b in zip(cds, box_cds))
    rec.update(windows_vs_box_max_abs=win, cd_rel_diff_vs_12a=cd_rel,
               cd_history_12a=box_rec["cd_history"], slip_12a=box_rec["slip"],
               t_history_12a=box_rec["t_history"],
               ms_per_step_12a=box_rec["ms_per_step"])
    print(f"  windows vs the box coupling's on 12a's mesh: max |w_gmsh - "
          f"w_box| {win:.3e} (limit {IBM_GMSH_WINDOW_LIMIT:g}); cd {cds} vs "
          f"12a {box_cds}: rel diff {cd_rel:.3e} (limit "
          f"{IBM_GMSH_BOX_CD_LIMIT:g}, the CPU pair {IBM_GMSH_BOX_CD_CPU:g}); "
          f"slip {rec['slip_per_step'][-1]:.3e} vs 12a {box_rec['slip']:.3e}"
          f"; t {p.t_history} vs 12a {box_rec['t_history']}", flush=True)
    if not win <= IBM_GMSH_WINDOW_LIMIT:
        fail(f"15d: windows differ from the box coupling's by {win:.3e}")
    if len(cds) != len(box_cds) or not cd_rel <= IBM_GMSH_BOX_CD_LIMIT:
        fail(f"15d: cd history vs 12a {cd_rel:.3e}")


def phase_ibm_gmsh_legs(torch, stencil, phase, out):
    """Phase 15 (see the module's docstring)."""
    from pynama_tpu_torch.cases.immersed import (
        ImmersedBoundaryDynamicProblem, ImmersedBoundaryProblem)
    from pynama_tpu_torch.ibm.coupling import (LatticeIBMCoupling,
                                               UnstructuredIBMCoupling)

    held = {}
    with tempfile.TemporaryDirectory() as tmp:
        held["ibm_gmsh_re40"] = phase(
            "ibm_gmsh_re40", "[15a] static cylinder, the Re-40 geometry on "
            "a graded Gmsh mesh, float64, 3 steps",
            lambda: ibm_gmsh_leg(torch, stencil, tmp, out, "ibm_gmsh_re40",
                                 ibm_re40_config(), IBM_GMSH_RE40,
                                 ImmersedBoundaryProblem,
                                 UnstructuredIBMCoupling))
        held["ibm_gmsh_dynamic"] = phase(
            "ibm_gmsh_dynamic", "[15b] moving cylinder, ibm-dynamic.yaml's "
            "geometry on a graded Gmsh mesh, float64, 3 steps",
            lambda: ibm_gmsh_leg(torch, stencil, tmp, out,
                                 "ibm_gmsh_dynamic",
                                 IBM_CONFIGS["ibm-dynamic"], IBM_GMSH_DYN,
                                 ImmersedBoundaryDynamicProblem,
                                 LatticeIBMCoupling))
        phase("ibm_gmsh_card_vs_cpu", "[15c] 12x12 Gmsh IBM runs on the "
              "card vs the CPU; 15a's and 15b's first post-steps repeated",
              lambda: ibm_gmsh_card_vs_cpu(torch, tmp, out, held))
        phase("ibm_gmsh_box", "[15d] ibm-static.yaml's 48x48 box as a Gmsh "
              "file, 3 steps, against 12a",
              lambda: ibm_gmsh_box_leg(torch, stencil, tmp, out))


def padded_channel3d_config():
    """configs/channel3d.yaml's geometry, material and KLE settings
    (kle-rtol 1e-8, at most 2000 CG iterations) at 31x31x79 Q2 hexes:
    31 and 79 are prime, so the first multigrid jump pads to
    32x32x80."""
    cfg = channel3d_config()
    cfg["domain"]["box-mesh"]["nelem"] = list(PADDED_NELEM_3D)
    return {**cfg, "kle-rtol": PADDED_3D_RTOL, "kle-maxiter": 2000}


def padded_hierarchy(p, key):
    """The hierarchy's record; fails unless level 0's jump is padded."""
    mg = p.mg
    ext = mg.levels[0].ext_mesh
    if ext is None or any(lv.ext_mesh is not None for lv in mg.levels[1:]):
        fail(f"{key}: expected a padded first jump only, got extended "
             f"meshes {[lv.ext_mesh for lv in mg.levels]}")
    return {"mg_levels": [list(lv.mesh.nelem) for lv in mg.levels],
            "mg_ratios": mg.ratios, "ext_mesh": list(ext.nelem)}


def padded_extra(torch):
    """16a's record beside phase_main's: the hierarchy, and the
    symmetry of each mask's V-cycle on the card on seeded vectors."""
    import numpy as np

    def extra(p, vort):
        res = padded_hierarchy(p, "16a")
        rng = np.random.default_rng(16)
        sym = {}
        for name in p._mask_names:
            mask = getattr(p, name + "_b")
            a, b = (torch.as_tensor(rng.normal(size=tuple(mask.shape)),
                                    dtype=mask.dtype, device=mask.device)
                    for _ in range(2))
            Ma, Mb = p._minv[name](a).double(), p._minv[name](b).double()
            a, b = a.double(), b.double()
            gap = abs(float(torch.sum(a * Mb) - torch.sum(b * Ma)))
            sym[name] = gap / float(torch.linalg.norm(a)
                                    * torch.linalg.norm(Mb))
        res["vcycle_symmetry"] = sym
        print(f"  hierarchy {res['mg_levels']}, first jump padded to "
              f"{res['ext_mesh']}; V-cycle symmetry |<a,Mb> - <b,Ma>| / "
              f"(|a| |Mb|): {sym} (limit {SYMMETRY_LIMIT:g})", flush=True)
        if not all(v <= SYMMETRY_LIMIT for v in sym.values()):
            fail(f"16a: the padded V-cycle is not symmetric: {sym}")
        return res
    return extra


def padded_solve3d(torch, stencil, kern, make_problem, out):
    """Phase 16b: setup() and one MG-CG KLE solve (solve_kle) of the
    padded 3D channel from a seeded vorticity, the launch counts set to
    0 just before and read just after; the true float64 relative
    residual, formed anew, within PADDED_RESIDUAL_FACTOR x the KLE
    rtol. Returns the record and the logged shapes."""
    import numpy as np

    for k in stencil.LIBRARIES:
        k.reset_counts()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = make_problem().setup()
    torch.cuda.synchronize()
    t_setup = time.perf_counter()
    rng = np.random.default_rng(79)
    w = torch.as_tensor(rng.normal(size=p._gshape(p.dim_w)), dtype=p.dtype,
                        device=p.device)
    t = p.t_start
    u = p.solve_kle(t, w)
    torch.cuda.synchronize()
    t_solve = time.perf_counter()
    launches = {k.name: k.launches for k in stencil.KERNELS.values()}
    logged = dict(kern.shapes)
    b = p.system.rhs(p._blk(w), p._solver_bc(t), p.free_mask_b)
    r = b - p.system.apply_masked(p._blk(u), p.free_mask_b)
    rel = float(torch.linalg.norm(r) / torch.linalg.norm(b))
    limit = PADDED_RESIDUAL_FACTOR * p.kle_rtol
    res = {"nelem": list(p.nelem), "velocity_dofs": p.mesh.n_nodes * p.dim,
           "dtype": str(p.dtype).replace("torch.", ""),
           "kle_rtol": p.kle_rtol, **padded_hierarchy(p, "16b"),
           "setup_s": t_setup - t0, "solve_s": t_solve - t_setup,
           "cg_iters": p.cg_iters, "true_rel_residual": rel,
           "stencil_launches": launches[kern.name],
           "launches_by_kernel": launches,
           "logged_shapes": [[list(s[0]), list(s[1]), s[2], c]
                             for s, c in logged.items()],
           "lam_max": p.mg.lam_max,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    out["padded_channel3d"] = res
    print(f"  {res['velocity_dofs']} velocity dofs, hierarchy "
          f"{res['mg_levels']}, first jump padded to {res['ext_mesh']}; "
          f"setup {res['setup_s']:.2f} s, solve {res['solve_s']:.2f} s, CG "
          f"iterations {p.cg_iters}, true float64 relative residual "
          f"{rel:.3e} (limit {limit:g}), {kern.name} launches "
          f"{launches[kern.name]}, peak memory {res['peak_mem_gib']:.2f} "
          "GiB", flush=True)
    if not bool(torch.isfinite(u).all()):
        fail("16b: the velocity is not finite")
    if not rel <= limit:
        fail(f"16b: true residual {rel:.3e} > {limit:g}")
    if launches[kern.name] <= 0:
        fail(f"16b: the solve launched no {kern.name} kernel")
    return res, logged


def phase_padded_legs(torch, stencil, phase, out):
    """Phase 16 (see the module's docstring). Returns 16a's phase_main
    record, the stencil2d rows at its shapes, 16b's record and the
    stencil3d rows at its shapes."""
    from pynama_tpu_torch.cases.cavity import CavityProblem
    from pynama_tpu_torch.cases.uniform import UniformFlowProblem

    k2, k3 = stencil.KERNEL, stencil.KERNEL3D
    n2 = PADDED_NELEM_2D
    sl, logged = phase(
        "padded_cavity", f"[16a] padded hierarchy: {n2}x{n2} cavity, "
        f"float32, {PADDED_STEPS} steps",
        lambda: phase_main(torch, stencil, k2,
                           lambda: CavityProblem(cavity_config(n2),
                                                 dtype=torch.float32),
                           "padded_cavity", out, extra=padded_extra(torch),
                           steps=PADDED_STEPS))
    base = out["cavity"]
    print(f"  beside phase 3 (384x384, this call): step 2 "
          f"{sl['step_ms'][0]:.1f} vs {base['step_ms'][0]:.1f} ms, setup "
          f"{sl['setup_s']:.2f} vs {base['setup_s']:.2f} s, CG iterations "
          f"per solve {sl['cg_iters_per_solve']:.2f} vs "
          f"{base['cg_iters_per_solve']:.2f}", flush=True)
    rows2 = phase(
        "padded_cavity_kernels", "[16a] stencil2d vs plain version at the "
        "padded cavity's shapes, with cuDNN",
        lambda: phase_logged_kernels(torch, stencil, k2, logged,
                                     sl["stencil_launches"],
                                     "padded_cavity_kernels", out))
    nx, ny, nz = PADDED_NELEM_3D
    res3, logged3 = phase(
        "padded_channel3d", f"[16b] padded hierarchy: channel3d {nx}x{ny}x"
        f"{nz}, float64, one KLE solve at rtol {PADDED_3D_RTOL:g}",
        lambda: padded_solve3d(
            torch, stencil, k3,
            lambda: UniformFlowProblem(padded_channel3d_config(),
                                       dtype=torch.float64), out))
    rows3 = phase(
        "padded_channel3d_kernels", "[16b] stencil3d vs plain version at "
        "the padded solve's shapes, with cuDNN",
        lambda: phase_logged_kernels(torch, stencil, k3, logged3,
                                     res3["stencil_launches"],
                                     "padded_channel3d_kernels", out))
    return sl, rows2, res3, rows3


# ----------------------------------------------------------------------
# phase 17: distributed runs (parallel/, run_case -sharded) through NCCL
# ----------------------------------------------------------------------
SHARDED_STEPS = 3
# 17a/17c against phase 3: the owned-weight dots sum in another order,
# so CG may stop an iteration apart; the ws legs' bound at KLE rtol 1e-5
SHARDED_LIMIT = 1e-4
# 17d: ShardedUnstructuredProblem's steps on 14a's cavity (cut from 2:
# its first step alone, two attempts, is 30 solves of ~1,840 Jacobi-CG
# iterations), and the
# elemental applies of one dual-mask RHS besides its CG solves' (Rw and
# K bc for each of the two solves, two curls, SrT and DivSrT)
SHARDED_UNSTRUCTURED_STEPS = 1
RHS_FIXED_APPLIES = 8
# 17b: the steps of run_case -sharded 1 (cut from 2 to make room for
# 17d), and the reference's {case}-sharded{N}-metrics.yaml keys
SHARDED_CLI_STEPS = 1
SHARDED_METRICS = {"steps", "final_time", "elapsed_s", "devices", "n_dofs",
                   "platform", "distributed_multigrid", "s_per_step_steady",
                   "vort_norm"}


def sharded_run(torch, stencil, sp, steps):
    """sp.run(max_steps=steps) with the launch and collective counts set
    to 0 just before and read just after: per-step marks, the record."""
    p, k2 = sp.p, stencil.KERNEL
    marks = []

    def cb(n, t, dt, w, vel):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), k2.launches, len(p.cg_iters),
                      dict(sp.ranks.counts)))

    for k in stencil.LIBRARIES:
        k.reset_counts()
    sp.ranks.counts.clear()
    p.cg_iters.clear()
    torch.cuda.synchronize()
    w, t, n = sp.run(max_steps=steps, callback=cb)
    torch.cuda.synchronize()
    counts, iters = dict(sp.ranks.counts), list(p.cg_iters)
    (ta, la, ia, ca), (tb, lb, ib, cb_) = marks[0], marks[-1]
    its = sum(iters[ia:ib])  # steps 2..steps
    res = {"steps": n, "t": t, "stencil_launches": k2.launches,
           "logged_shapes": dict(k2.shapes),
           "step_ms": [1e3 * (b[0] - a[0]) for a, b in zip(marks,
                                                           marks[1:])],
           "cg_iters": iters, "kle_solves": len(iters),
           "cg_iters_per_solve": sum(iters) / len(iters),
           "collectives": counts,
           "per_cg_iteration_steps_2on": {
               k: (cb_.get(k, 0) - ca.get(k, 0)) / max(its, 1)
               for k in ("all_reduce", "all_gather", "halo")},
           "stencil_launches_per_cg_iteration_steps_2on":
               (lb - la) / max(its, 1)}
    res["ms_per_step"] = sum(res["step_ms"]) / len(res["step_ms"])
    return w, res


def sharded_rank(rank, nelem, steps):
    """17c, on rank r (cuda:r) of an N-rank NCCL group: the cavity at
    nelem x nelem through ShardedNSProblem(p, N).run(); rank 0 also
    returns the global vorticity."""
    import torch
    import torch.distributed as dist

    from pynama_tpu_torch.cases.cavity import CavityProblem
    from pynama_tpu_torch.ops import stencil
    from pynama_tpu_torch.parallel.sharded_problem import ShardedNSProblem

    p = CavityProblem(cavity_config(nelem), dtype=torch.float32,
                      device=torch.device("cuda", rank)).setup()
    sp = ShardedNSProblem(p, dist.get_world_size())
    w, res = sharded_run(torch, stencil, sp, steps)
    vort = sp.unshard(w, 1)
    res.pop("logged_shapes")
    return dict(res, vort=vort if rank == 0 else None)


def sharded_single(torch, stencil, base_vort, base, out):
    """17a (see the module's docstring); returns its record."""
    import numpy as np
    import torch.distributed as dist

    from pynama_tpu_torch.cases.cavity import CavityProblem
    from pynama_tpu_torch.parallel import launch
    from pynama_tpu_torch.parallel.sharded_problem import ShardedNSProblem

    with tempfile.TemporaryDirectory() as tmp:
        launch.init_group("nccl", "file://" + os.path.join(tmp, "rdv"), 1, 0)
        try:
            t0 = time.perf_counter()
            p = CavityProblem(cavity_config(384), dtype=torch.float32).setup()
            sp = ShardedNSProblem(p, 1)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            for op in (sp.K_op, sp.Rw_op, sp.Curl_op, sp.SrT_op, sp.Div_op):
                op._kernels()  # built at their first apply otherwise
            tensors = problem_tensors(torch, sp, skip=(sp.p,))
            here = {str(x.device) for x in tensors}
            w, res = sharded_run(torch, stencil, sp, SHARDED_STEPS)
            vort = sp.unshard(w, 1)
        finally:
            dist.destroy_process_group()
    ref = base_vort.reshape(-1).cpu().numpy().astype(np.float64)
    rel = float(np.linalg.norm(vort - ref) / np.linalg.norm(ref))
    res.update(setup_s=setup_s, vort_rel_diff_vs_phase3=rel,
               tensors=len(tensors), tensor_devices=sorted(here),
               dist_mg=sp._dmg is not None,
               device_count=torch.cuda.device_count(),
               phase3_ms_per_step=base["ms_per_step"],
               phase3_cg_iters_per_solve=base["cg_iters_per_solve"])
    out["sharded_1"] = {k: v for k, v in res.items() if k != "logged_shapes"}
    per = res["per_cg_iteration_steps_2on"]
    print(f"  1 NCCL rank, {torch.cuda.device_count()} card(s) visible; "
          f"setup {setup_s:.2f} s; {res['ms_per_step']:.1f} ms/step "
          f"(steps 2-{SHARDED_STEPS}: {res['step_ms']}) beside phase 3's "
          f"{base['ms_per_step']:.1f} ({base['step_ms']}); "
          f"{res['cg_iters_per_solve']:.2f} CG iterations per solve "
          f"(phase 3: {base['cg_iters_per_solve']:.2f})", flush=True)
    print(f"  per CG iteration (steps 2-{SHARDED_STEPS}): "
          f"{per['all_reduce']:.2f} all-reduces, {per['all_gather']:.2f} "
          f"all-gathers, {per['halo']:.2f} halo exchanges, "
          f"{res['stencil_launches_per_cg_iteration_steps_2on']:.1f} "
          f"stencil2d launches; {len(tensors)} tensors on {sorted(here)}; "
          f"vorticity vs phase 3 {rel:.3e} (limit {SHARDED_LIMIT:g})",
          flush=True)
    if res["steps"] != SHARDED_STEPS or not rel <= SHARDED_LIMIT:
        fail(f"17a: {res['steps']} steps, vorticity {rel:.3e} off phase 3")
    if here != {"cuda:0"} or not res["dist_mg"]:
        fail(f"17a: tensors on {here}, distributed multigrid "
             f"{res['dist_mg']}")
    if res["stencil_launches"] <= 0 or not res["collectives"].get(
            "all_reduce"):
        fail("17a: no stencil2d launch or no all-reduce on the main path")
    return res


def sharded_cli(torch, out):
    """17b: run_case -sharded 1 on the card (one spawned NCCL rank), then
    the refusal of -sharded <visible cards + 1>."""
    import yaml

    from pynama_tpu_torch import run_case

    n_cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        save = os.path.join(tmp, "run")
        base = ["-case", "cavity", "-nelem", "32", "32", "-max-steps",
                str(SHARDED_CLI_STEPS), "-log", "WARNING", "-opt",
                f"save-dir={save}"]
        t0 = time.perf_counter()
        m = run_case.main(base + ["-sharded", "1"])
        secs = time.perf_counter() - t0
        with open(os.path.join(save, "cavity-sharded1-metrics.yaml")) as f:
            saved = yaml.safe_load(f)
        with open(os.path.join(save, "owner.vtk")) as f:
            lines = f.read().splitlines()
        owner = [float(v) for v in
                 lines[lines.index("LOOKUP_TABLE default") + 1:]]
        refused = None
        try:
            run_case.main(base + ["-sharded", str(n_cards + 1)])
        except SystemExit as e:
            refused = str(e.code)
    want = f"-sharded {n_cards + 1}: only {n_cards} devices visible"
    res = {"metrics": m, "seconds": secs, "owner_points": len(owner),
           "refusal": refused}
    out["sharded_cli"] = res
    print(f"  -sharded 1: {secs:.1f} s, metrics {m}; owner.vtk "
          f"{len(owner)} points; -sharded {n_cards + 1}: {refused!r}",
          flush=True)
    if set(m) != SHARDED_METRICS or saved != m \
            or m["steps"] != SHARDED_CLI_STEPS \
            or m["platform"] != "cuda" or m["devices"] != 1 \
            or not m["distributed_multigrid"] \
            or not math.isfinite(m["vort_norm"]):
        fail(f"17b: -sharded 1 metrics {m}")
    if len(owner) != 65 * 65 or any(v != 0.0 for v in owner):
        fail("17b: owner.vtk does not hold rank 0 at every node")
    if refused is None or not refused.startswith(want):
        fail(f"17b: -sharded {n_cards + 1} was not refused: {refused!r}")
    return res


def sharded_multi(torch, base_vort, out):
    """17c: 17a's run on 2 and 4 NCCL ranks where that many cards are
    visible; their stencil2d launches by N."""
    import numpy as np

    from pynama_tpu_torch.parallel import launch

    n_cards = torch.cuda.device_count()
    ref = base_vort.reshape(-1).cpu().numpy().astype(np.float64)
    legs, launches = {}, {}
    for n in (2, 4):
        if n_cards < n:
            print(f"  N = {n}: {n_cards} card(s) visible, not run",
                  flush=True)
            legs[n] = None
            continue
        res = launch.spawn(sharded_rank, n, args=(384, SHARDED_STEPS),
                           backend="nccl", deadline=600)
        vort = res[0].pop("vort")
        rel = float(np.linalg.norm(vort - ref) / np.linalg.norm(ref))
        launches[f"17c N={n}"] = sum(r["stencil_launches"] for r in res)
        legs[n] = dict(res[0], vort_rel_diff_vs_phase3=rel)
        print(f"  N = {n}: {res[0]['ms_per_step']:.1f} ms/step, "
              f"{res[0]['cg_iters_per_solve']:.2f} CG iterations per solve, "
              f"vorticity vs phase 3 {rel:.3e}", flush=True)
        if res[0]["steps"] != SHARDED_STEPS or not rel <= SHARDED_LIMIT:
            fail(f"17c N={n}: vorticity {rel:.3e} off phase 3")
    out["sharded_multi"] = {str(k): v for k, v in legs.items()}
    return launches


def unstructured_run(torch, pu, p, sp):
    """17d's sp.run(max_steps=SHARDED_UNSTRUCTURED_STEPS), timed a step
    (step 1 with the initial RHS), with its CG iterations and
    all-reduces; the run's initial RHS (its two solves' velocities
    recorded at pu.cg_solve) against the problem's own single-device RHS
    on the same inputs, from the same warm starts (the final solve from
    the free-slip one's, as the wrapper's)."""
    marks, first, cg, once = [], {}, pu.cg_solve, sp._eval_rhs_once

    def recorded(*args, **kwargs):
        res = cg(*args, **kwargs)
        first["solved"].append(res.x)
        return res

    def first_rhs(w, t, vel):
        first.update(solved=[], t0=time.perf_counter())
        pu.cg_solve = recorded
        try:
            first["f"] = once(w, t, vel)
            torch.cuda.synchronize()
        finally:
            pu.cg_solve = cg
        first.update(seconds=time.perf_counter() - first["t0"],
                     cg_iters=list(p.cg_iters),
                     all_reduce=sp.counts["all_reduce"])
        return first["f"]

    def cb(n, t, dt, w, vel):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), dt))

    p.cg_iters.clear()
    sp.counts.clear()
    sp._eval_rhs_once = first_rhs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        w, t, n = sp.run(max_steps=SHARDED_UNSTRUCTURED_STEPS, callback=cb)
        torch.cuda.synchronize()
    finally:
        del sp._eval_rhs_once
    iters, n_ar = list(p.cg_iters), sp.counts["all_reduce"]
    starts = [t0] + [m[0] for m in marks]
    res = {"steps": n, "t": t, "dt": [m[1] for m in marks],
           "finite": bool(torch.isfinite(w).all()),
           "step_ms": [1e3 * (b - a) for a, b in zip(starts, starts[1:])],
           "first_step_incl_initial_rhs": True,
           "kle_solves": len(iters), "cg_iters": iters,
           "cg_iters_per_solve": sum(iters) / max(len(iters), 1),
           "all_reduce": n_ar,
           "all_reduce_formula": sum(i + 1 for i in iters)
           + RHS_FIXED_APPLIES * (len(iters) // 2),
           "all_reduce_per_cg_iteration": n_ar / max(sum(iters), 1)}

    p.cg_iters.clear()
    t1 = time.perf_counter()
    f1, aux = p.transport_rhs(p.t_start, p.initial_vorticity(), (
        p.zero_vel(), None))
    torch.cuda.synchronize()
    mine, single = [first["f"]] + first["solved"], (f1,) + aux
    res["initial_rhs"] = {
        "rel_diff_rhs_vel_fs_vel": [rel_diff(torch, a, b)
                                    for a, b in zip(mine, single)],
        "bitwise": len(mine) == 3 and all(
            bool(torch.equal(a, b)) for a, b in zip(mine, single)),
        "cg_iters": first["cg_iters"], "single_cg_iters": list(p.cg_iters),
        "all_reduce": first["all_reduce"],
        "all_reduce_formula": sum(i + 1 for i in first["cg_iters"])
        + RHS_FIXED_APPLIES, "seconds": first["seconds"],
        "single_seconds": time.perf_counter() - t1}
    return res


def sharded_unstructured(torch, stencil, out):
    """17d (see the module's docstring); returns its record."""
    import torch.distributed as dist

    import pynama_tpu_torch.parallel.unstructured as pu
    from pynama_tpu_torch.cases.cavity import CavityProblem
    from pynama_tpu_torch.parallel import launch

    n = GMSH_CAVITY_N
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cavity.msh")
        pts, quads = box_corner_mesh(n, n, distort=0.15 / n, seed=1)
        write_msh22(path, pts, quads, 3)
        cfg = dict(gmsh_cavity_config(path, n), **{"unstructured-pc":
                                                   "jacobi"})
        launch.init_group("nccl", "file://" + os.path.join(tmp, "rdv"), 1, 0)
        try:
            # NCCL makes its communicator at the first collective: here,
            # outside the timed run
            dist.barrier()
            for k in stencil.LIBRARIES:
                k.reset_counts()
            t0 = time.perf_counter()
            p = CavityProblem(cfg).setup()
            sp = pu.ShardedUnstructuredProblem(p, 1)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            tensors = problem_tensors(torch, sp, skip=(sp.p,))
            here = {str(x.device) for x in tensors}
            res = unstructured_run(torch, pu, p, sp)
            launches = {k.name: k.launches for k in stencil.KERNELS.values()}
        finally:
            dist.destroy_process_group()
    res.update(cells=p.mesh.n_cells, velocity_dofs=sp.n_vel,
               setup_s=setup_s, setup_split_s=dict(p.setup_s),
               tensors=len(tensors), tensor_devices=sorted(here),
               stencil_launches=launches)
    out["sharded_unstructured"] = res
    first = res["initial_rhs"]
    print(f"  {res['cells']} cells, {res['velocity_dofs']} velocity dofs; "
          f"setup {setup_s:.2f} s; {len(tensors)} tensors on "
          f"{sorted(here)}; stencil launches {launches}", flush=True)
    rels = ", ".join(f"{r:.3e}" for r in first["rel_diff_rhs_vel_fs_vel"])
    print(f"  initial RHS vs the single-device problem's: RHS, free-slip "
          f"and final velocity {rels} (limit {GMSH_CPU_LIMIT:g}), bitwise "
          f"{first['bitwise']}; CG "
          f"{first['cg_iters']} (single-device {first['single_cg_iters']}); "
          f"{first['all_reduce']} all-reduces (formula "
          f"{first['all_reduce_formula']}); {first['seconds']:.2f} s "
          f"(single-device {first['single_seconds']:.2f} s)", flush=True)
    print(f"  {res['steps']} steps: {[round(x, 1) for x in res['step_ms']]} "
          f"ms (step 1 with the initial RHS), dt {res['dt']}; "
          f"{res['kle_solves']} KLE solves, {res['cg_iters_per_solve']:.1f} "
          f"CG iterations per solve (max {max(res['cg_iters'])}); "
          f"{res['all_reduce']} all-reduces (formula "
          f"{res['all_reduce_formula']}), "
          f"{res['all_reduce_per_cg_iteration']:.4f} a CG iteration; "
          f"finite {res['finite']}", flush=True)
    if here != {"cuda:0"} or any(launches.values()):
        fail(f"17d: tensors on {here}, stencil launches {launches}")
    if not max(first["rel_diff_rhs_vel_fs_vel"]) <= GMSH_CPU_LIMIT:
        fail("17d: the initial RHS is off the single-device problem's")
    if first["all_reduce"] != first["all_reduce_formula"] or \
            res["all_reduce"] != res["all_reduce_formula"]:
        fail("17d: the all-reduces are not one an elemental apply")
    if res["steps"] != SHARDED_UNSTRUCTURED_STEPS or not res["finite"]:
        fail(f"17d: {res['steps']} steps, finite vorticity {res['finite']}")
    return res


def phase_sharded_legs(torch, stencil, phase, base_vort, checked, out):
    """Phase 17 (see the module's docstring). Returns stencil2d's
    launches by leg and the rows of 17a's new shapes."""
    from collections import Counter

    res = phase("sharded_1", "[17a] distributed path, 1 NCCL rank: 384x384 "
                f"cavity, float32, {SHARDED_STEPS} steps",
                lambda: sharded_single(torch, stencil, base_vort,
                                       out["cavity"], out))
    phase("sharded_cli", "[17b] run_case -sharded 1 on the card, and the "
          "refusal of more ranks than cards",
          lambda: sharded_cli(torch, out))
    launches = phase("sharded_multi", "[17c] 17a on 2 and 4 NCCL ranks, "
                     "where that many cards are visible",
                     lambda: sharded_multi(torch, base_vort, out))
    phase("sharded_unstructured", "[17d] ShardedUnstructuredProblem, 1 NCCL "
          f"rank: 14a's {GMSH_CAVITY_N}x{GMSH_CAVITY_N} Gmsh cavity, f64, "
          f"Jacobi-CG, {SHARDED_UNSTRUCTURED_STEPS} step(s)",
          lambda: sharded_unstructured(torch, stencil, out))
    launches["17a"] = res["stencil_launches"]
    new = Counter({s: c for s, c in res["logged_shapes"].items()
                   if s not in checked})
    rows = phase("sharded_kernels", "[17a] stencil2d vs plain version at "
                 "the distributed path's new shapes",
                 lambda: phase_logged_kernels(torch, stencil, stencil.KERNEL,
                                              new, sum(new.values()),
                                              "sharded_kernels", out))
    return launches, rows


def kernel_entry(name, replaces, launches, head, max_abs_err, **extra):
    """One entry of the "kernels" line; ``head`` holds the kernel's,
    the plain version's and the library call's times and the bound at the
    shape the entry reports."""
    return {
        "name": name,
        "route": "cuda",
        "source": f"pynama_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        **extra,
    }


def main_path_entry(kern, rows, launches, replaces, v1_launches, **more):
    """The entry of a main-path kernel from its phase-5 rows, at its
    busiest float32 shape, with its first design's time and launches
    (phase 5's) and every row's plan."""
    f32 = [r for r in rows if r["dtype"] == "float32"]
    head = f32[0]
    keys = ("dtype", "x", "W", "main_path_launches", "max_rel_err",
            "kernel_ms", "kernel_ms_again", "plain_ms", "library_ms",
            "bound_ms", "v1_ms", "graph_ms", "v1_graph_ms", "plan",
            "share_of_bound")
    extra = {k: head[k] for k in ("v1_ms", "graph_ms", "v1_graph_ms")}
    return kernel_entry(
        kern.name, replaces, launches, head,
        max(r["max_abs_err"] for r in f32),
        at=f"x {tuple(head['x'])} float32, W {tuple(head['W'])}",
        v1_launches=v1_launches, plan=head["plan"],
        shapes=[{k: r[k] for k in keys} for r in rows], **extra, **more)


def phase_breakdown(torch, stencil, out):
    """Phase 9: the breakdown kernel of both designs against its plain
    version in every mode, precision and tile, full/highest at TR 8
    against stencil.conv_blocked bit for bit, then every row of
    run_breakdown and the cuDNN yardsticks timed; returns the kernel's
    entry for the "kernels" line."""
    import numpy as np
    import torch.nn.functional as tnf

    from pynama_tpu_torch.scripts import stencil_breakdown as sb

    torch.backends.cudnn.allow_tf32 = False
    # the static SASS of every kernel of stencil2d and the breakdown:
    # shared loads and stores, FMAs, wgmmas and cp.asyncs per chunk of
    # the unrolled sweep
    sass = {}
    for k in (stencil.KERNEL, stencil.BREAKDOWN):
        counts = sb.library_sass(k, sb.SASS_OPS_BREAKDOWN)
        if counts is None:
            print(f"  {k.name}: no cuobjdump, no SASS counts", flush=True)
            continue
        for name, c in counts.items():
            sass[f"{k.name}: {name}"] = c
            print(f"  SASS {k.name}: {name}: " + ", ".join(
                f"{op} {n}" for op, n in c.items()), flush=True)
    checks, inputs, bitwise = [], {}, []
    for shape in BREAKDOWN_SHAPES:
        rng = np.random.default_rng(sum(shape))
        C = shape[-1]
        x = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                            device="cuda")
        W = torch.as_tensor(rng.normal(size=(3, 3, C, C)),
                            dtype=torch.float32, device="cuda")
        inputs[shape] = x, W
        x64, W64 = x.double(), W.double()
        refs = {(mode, prec): sb.breakdown_plain(mode, prec, x64, W64)
                for mode in sb.MODES for prec in sb.PRECISIONS}
        for design, TR, mode, prec in itertools.product(
                sb.DESIGNS, sb.TILE_ROWS, sb.MODES, sb.PRECISIONS):
            y32 = sb.make_breakdown(mode, prec, TR, design)(x, W)
            y, ref = y32.double(), refs[mode, prec]
            abs_err = float((y - ref).abs().max())
            rel = abs_err / float(ref.abs().max())
            tol = BREAKDOWN_TOL["fill" if mode == "fill" else prec]
            name = f"{mode}/{prec} [{design}]"
            row = {"x": list(shape), "TR": TR, "design": design,
                   "mode": mode, "precision": prec, "max_abs_err": abs_err,
                   "max_rel_err": rel, "tolerance": tol}
            msg = (f"  x {shape} TR {TR:2d} {name:24s} rel err {rel:.2e} "
                   f"(limit {tol:g})")
            if mode != "fill" and prec == "default":
                unr = refs[mode, "highest"]
                row["rel_err_vs_unrounded"] = float(
                    (y - unr).abs().max()) / float(unr.abs().max())
                msg += (f"; {row['rel_err_vs_unrounded']:.2e} against the "
                        "unrounded plain version (reported only)")
            checks.append(row)
            print(msg, flush=True)
            if not rel <= tol:
                fail(f"stencil_breakdown {name} TR {TR} at x {shape}: "
                     f"{rel:.3e} > {tol:g}")
            if (design, TR, mode, prec) == ("igemm", 8, "full", "highest"):
                same = torch.equal(y32, stencil.conv_blocked(x, W))
                bitwise.append({"x": list(shape), "equal": same,
                                "plan": sb.breakdown_plan(
                                    prec, TR, shape)._asdict()})
                print(f"  x {shape} TR  8 full/highest vs "
                      f"stencil.conv_blocked: bitwise {same}", flush=True)
                if not same:
                    fail(f"full/highest at TR 8 is not stencil2d's output "
                         f"bit for bit at x {shape}: the breakdown does not "
                         "run production's design")

    for k in stencil.LIBRARIES:
        k.reset_counts()
    runs, library = [], {}
    for shape in BREAKDOWN_SHAPES:
        for TR in sb.TILE_ROWS:
            print(f"  shape {shape} TR={TR}: graph ms / eager ms per apply, "
                  "bound, share of the bound", flush=True)
            rows = sb.run_breakdown(*shape, TR)
            # the TF32 family's staging alone (fill has one row in the
            # TPU script's table, the IEEE family's)
            fill_tf32 = sb.make_breakdown("fill", "default", TR)
            graph_ms, eager_ms = sb.time_chain(
                lambda v: fill_tf32(v, inputs[shape][1]), inputs[shape][0])
            runs.append({"x": list(shape), "TR": TR, "rows": rows,
                         "fill_default_ms": {"graph_ms": graph_ms,
                                             "eager_ms": eager_ms}})
            for r in rows:
                print(f"    {r['name']:<54s} {r['graph_ms']:8.4f} "
                      f"{r['eager_ms']:8.4f}  bound {r['bound_ms']:.4f} "
                      f"({r['bound_by']})  {100 * r['share']:5.1f}%"
                      + (f"  [{r['note']}]" if "note" in r else ""),
                      flush=True)
        library[shape] = sb.cudnn_rows(*shape)
        for r in library[shape]:
            print(f"    {r['name']:<54s} {r['graph_ms']:8.4f} "
                  f"{r['eager_ms']:8.4f}  bound {r['bound_ms']:.4f} "
                  f"({r['bound_by']})  {100 * r['share']:5.1f}%  x {shape}",
                  flush=True)
    launches = stencil.BREAKDOWN.launches
    if launches <= 0:
        fail("phase 9 launched no stencil_breakdown kernel")

    split, slower = [], []
    for run in runs:
        t = {r["name"]: r["graph_ms"] for r in run["rows"]}
        lib = {r["name"]: r["graph_ms"] for r in library[tuple(run["x"])]}
        full, prod = t["full/highest"], t[sb.PRODUCTION]
        split.append({
            "x": run["x"], "TR": run["TR"], "full": full,
            "fill": t["fill-only"], "mm": t["mm-only/highest"],
            "production": prod, "full_over_production": full / prod,
            "full_default": t["full/default"],
            "fill_default": run["fill_default_ms"]["graph_ms"],
            "mm_default": t["mm-only/default"],
            "cudnn_tf32_off": lib[sb.CUDNN["highest"]],
            "cudnn_tf32_on": lib[sb.CUDNN["default"]],
            "v1": {n: t[n + " [v1]"] for n, _, _ in sb.KERNEL_ROWS}})
        print(f"  x {tuple(run['x'])} TR {run['TR']:2d}: full/highest "
              f"{full:.4f} ms | fill-only {t['fill-only']:.4f} + "
              f"mm-only/highest {t['mm-only/highest']:.4f} = "
              f"{t['fill-only'] + t['mm-only/highest']:.4f} ms | production "
              f"stencil2d {prod:.4f} ms, full / production "
              f"{full / prod:.3f} | full/default {t['full/default']:.4f}, "
              f"fill/default {run['fill_default_ms']['graph_ms']:.4f}, "
              f"mm-only/default {t['mm-only/default']:.4f} ms | cuDNN "
              f"{lib[sb.CUDNN['highest']]:.4f} (TF32 off), "
              f"{lib[sb.CUDNN['default']]:.4f} (on)", flush=True)
        if run["TR"] == 8 and abs(full / prod - 1) > SAME_DESIGN_GAP:
            fail(f"full/highest at TR 8 ({full:.4f} ms) is not production "
                 f"stencil2d ({prod:.4f} ms) at x {run['x']}: the breakdown "
                 "does not measure the design it takes apart")
        for name, mode, _ in sb.KERNEL_ROWS:
            if mode != "fill" and t[name] > t[name + " [v1]"]:
                slower.append(f"{name} {t[name]:.4f} ms > [v1] "
                              f"{t[name + ' [v1]']:.4f} ms at x {run['x']} "
                              f"TR {run['TR']}")
    if slower:
        fail("the redesigned breakdown is slower than its first design: "
             + "; ".join(slower))

    # the entry: full/highest (and full/default) at the fine K shape, tile
    # rows 8
    shape = BREAKDOWN_SHAPES[0]
    x, W = inputs[shape]
    rows = {r["name"]: r for r in runs[0]["rows"]}
    row, row_tf32 = rows["full/highest"], rows["full/default"]
    lib_fn, _ = library_call(tnf, x, W)
    head = {"kernel_ms": row["eager_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "plain_ms": event_ms(torch, lambda: sb.breakdown_plain(
                "full", "highest", x, W), 20),
            "library_ms": event_ms(torch, lib_fn, 20)}
    with sb.cudnn_tf32(True):
        library_tf32_ms = event_ms(torch, lib_fn, 20)
    out["stencil_breakdown"] = {"checks": checks, "bitwise": bitwise,
                                "runs": runs, "library": [
                                    {"x": list(s), "rows": r}
                                    for s, r in library.items()],
                                "split": split, "launches": launches,
                                "entry": head, "sass": sass}
    return kernel_entry(
        "stencil_breakdown", "scripts/stencil_breakdown_tpu.py:55",
        launches, head, max(c["max_abs_err"] for c in checks),
        main_path_launches=0, graph_ms=row["graph_ms"],
        default_ms=row_tf32["eager_ms"],
        default_graph_ms=row_tf32["graph_ms"],
        default_bound_ms=row_tf32["bound_ms"],
        default_library_ms=library_tf32_ms,
        default_prepare_ms=row_tf32["prepare_ms"],
        at=f"x {shape} float32, full/highest (default_*: full/default, "
           "TF32 wgmma; its library call cuDNN with TF32 on), tile rows 8; "
           "ms is 64 eager launches, graph_ms the same chain as one CUDA "
           "graph; launches counts the eager launches, not the graph "
           "replays")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 8: step 3 of each main path under "
                         "torch.profiler")
    args = ap.parse_args()
    t_all = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # the port first: without it (a lone copy of this script) exit before
    # printing anything
    from pynama_tpu_torch.cases.analytic import CustomFuncProblem
    from pynama_tpu_torch.cases.cavity import CavityProblem
    from pynama_tpu_torch.cases.uniform import UniformFlowProblem
    from pynama_tpu_torch.ops import stencil
    from pynama_tpu_torch.scripts.stencil_breakdown import card_line

    k2, k3 = stencil.KERNEL, stencil.KERNEL3D
    # phases 3-9 run float32; phase 10, the parity leg, float64 state
    F32, F64 = torch.float32, torch.float64
    phase_s = {}
    mem_after = {}  # GiB still allocated after each phase
    out = {}

    def phase(key, title, fn):
        t0 = time.perf_counter()
        print(title, flush=True)
        res = fn()
        phase_s[key] = time.perf_counter() - t0
        mem_after[key] = torch.cuda.memory_allocated() / 2**30
        return res

    t0 = time.perf_counter()
    smi = card_line()
    print(f"[1] card: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32:
        fail("float32 matmuls are not full precision")
    phase_s["card"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    stencil.build_kernels()
    phase_s["build"] = time.perf_counter() - t0
    print("[2] built " + ", ".join(
        f"{k.source.name} in {k.build_seconds:.1f} s"
        for k in stencil.LIBRARIES) + ", in parallel", flush=True)
    for k in stencil.LIBRARIES:  # each kernel's name, registers, spills
        for ln in k.build_log.splitlines():
            if "Compiling entry function" in ln:
                ln = "entry " + ln.split("'")[1]
            elif "registers" not in ln and "spill" not in ln:
                continue
            print(f"    {k.name}: " + ln.strip(), flush=True)

    held = {}  # final vorticities (and 11a's problem) for phase 11
    sl2, logged2 = phase(
        "cavity", "[3] 2D main path: 384x384 cavity, 3 steps",
        lambda: phase_main(torch, stencil, k2,
                           lambda: CavityProblem(cavity_config(384),
                                                 dtype=F32),
                           "cavity", out, extra=keep_run(held, "cavity")))
    sl3, logged3 = phase(
        "channel3d", "[4] 3D main path: channel3d 32x32x80, 3 steps",
        lambda: phase_main(torch, stencil, k3,
                           lambda: UniformFlowProblem(channel3d_config(),
                                                      dtype=F32),
                           "channel3d", out,
                           extra=keep_run(held, "channel3d",
                                           channel_extra(torch))))
    rows2 = phase("kernel_check_2d",
                  "[5a] stencil2d vs plain version at the cavity's shapes, "
                  "beside its first design (v1)",
                  lambda: phase_kernels(torch, stencil, k2, logged2, out))
    phase("kernel_design_2d",
          "[5a] stencil2d instances: registers, SASS, repeat launches",
          lambda: phase_kernel_design(torch, stencil, k2, rows2, out))
    rows3 = phase("kernel_check_3d",
                  "[5b] stencil3d vs plain version at channel3d's shapes, "
                  "beside its first design (v1)",
                  lambda: phase_kernels(torch, stencil, k3, logged3, out))
    phase("kernel_design_3d",
          "[5b] stencil3d instances: registers, SASS, repeat launches",
          lambda: phase_kernel_design(torch, stencil, k3, rows3, out))
    phase("plain_compare_2d",
          "[6] 16x16 cavity: kernel vs plain version on the card",
          lambda: phase_plain_compare(
              torch, stencil, k2,
              lambda: CavityProblem(cavity_config(16), dtype=F32),
              "plain_compare_2d", out))
    phase("plain_compare_3d",
          "[7] 8x8x8 3D Taylor-Green: kernel vs plain version on the card",
          lambda: phase_plain_compare(
              torch, stencil, k3,
              lambda: CustomFuncProblem(taylor_green3d_config(),
                                        case="taylor-green", dtype=F32),
              "plain_compare_3d", out, exact_limit=0.15))
    if args.profile:
        phase("profile_2d", "[8a] profile: step 3 of the 384x384 cavity",
              lambda: phase_profile(
                  torch, k2,
                  lambda: CavityProblem(cavity_config(384), dtype=F32), sl2,
                  "profile_2d", out))
        phase("profile_3d", "[8b] profile: step 3 of channel3d",
              lambda: phase_profile(
                  torch, k3,
                  lambda: UniformFlowProblem(channel3d_config(), dtype=F32),
                  sl3, "profile_3d", out))
    breakdown = phase(
        "breakdown", "[9] stencil2d cost breakdown (its own path): "
        "modes vs plain, then timed",
        lambda: phase_breakdown(torch, stencil, out))
    sl10, logged10 = phase(
        "parity", "[10a] parity leg: 384x384 cavity, float64 refined by "
        f"kle.solve_ir to 1e-8, float32 inner solves, {PARITY_STEPS} steps",
        lambda: phase_main(torch, stencil, k2,
                           lambda: CavityProblem(parity_config(384),
                                                 dtype=F64),
                           "parity", out,
                           extra=parity_extra(torch, k2, held),
                           steps=PARITY_STEPS))
    phase("parity_residual",
          "[10b] parity self-check: true float64 residual of the final "
          "mask's solve",
          lambda: phase_parity_residual(torch, held.pop("p"), out))
    phase("plain_compare_parity",
          "[10c] 16x16 refined cavity: kernel vs plain version on the card",
          lambda: phase_plain_compare(
              torch, stencil, k2,
              lambda: CavityProblem({**cavity_config(16), "kle-refine": True,
                                     "kle-rtol": PARITY_RTOL}, dtype=F64),
              "plain_compare_parity", out, limit=1e-6))
    phase("refine3d",
          "[10d] 8x8x8 3D Taylor-Green: one refined KLE solve",
          lambda: phase_refine3d(
              torch, k3,
              lambda: CustomFuncProblem(
                  {**taylor_green3d_config(), "kle-refine": True,
                   "kle-rtol": PARITY_RTOL}, case="taylor-green", dtype=F64),
              out))
    phase("parity_kernels",
          "[10e] stencil2d vs plain version at the parity leg's shapes",
          lambda: phase_logged_kernels(torch, stencil, k2, logged10,
                                       sl10["stencil_launches"],
                                       "parity_kernels", out))
    sl11a, sl11c = phase_ws_legs(torch, stencil, phase, held, out)
    sl12, rows12 = phase_ibm_legs(torch, stencil, phase, out)
    checked = {(tuple(r["x"]), tuple(r["W"]), r["dtype"]) for r in
               rows2 + rows12 + out["parity_kernels"]["shapes"]}
    cli2, rows13 = phase_cli_legs(torch, stencil, phase, held["cavity"],
                                  checked, out)
    phase_gmsh_legs(torch, stencil, phase, out)
    phase_ibm_gmsh_legs(torch, stencil, phase, out)
    sl16a, rows16a, res16b, rows16b = phase_padded_legs(torch, stencil,
                                                        phase, out)
    checked |= {(tuple(r["x"]), tuple(r["W"]), r["dtype"])
                for r in rows13 + rows16a}
    sharded2, rows17 = phase_sharded_legs(torch, stencil, phase,
                                          held.pop("cavity"), checked, out)
    phase_s["total"] = time.perf_counter() - t_all
    print("phase seconds: " + json.dumps(phase_s), flush=True)
    print("GiB allocated after each phase: " + json.dumps(mem_after),
          flush=True)

    ws2 = {"11a": sl11a["stencil_launches"],
           "11b": out["ws_scan"]["stencil_launches"]}
    ibm2 = {leg: sl12[key]["stencil_launches"] for leg, key in (
        ("12a", "ibm_static"), ("12b", "ibm_dynamic"), ("12c", "ibm_re40"),
        ("12f", "ibm_re40_refine"), ("12g", "ibm_st_refine"))}
    kernels = {"kernels": [
        main_path_entry(k2, rows2, sl2["stencil_launches"]
                        + sl10["stencil_launches"] + sum(ws2.values())
                        + sum(ibm2.values()) + sum(cli2.values())
                        + sl16a["stencil_launches"]
                        + sum(sharded2.values()),
                        "pynama_tpu/ops/pallas_stencil.py:173",
                        out["stencil2d_v1_launches"],
                        also_replaces=["pynama_tpu/ops/pallas_stencil.py:273"],
                        parity_leg_launches=sl10["launches_by_instance"],
                        parity_leg_max_abs_err=max(
                            r["max_abs_err"]
                            for r in out["parity_kernels"]["shapes"]),
                        ws_leg_launches=ws2, ibm_leg_launches=ibm2,
                        ibm_leg_max_abs_err=max(
                            r["max_abs_err"] for r in rows12),
                        cli_leg_launches=cli2,
                        cli_leg_max_abs_err=max(
                            (r["max_abs_err"] for r in rows13),
                            default=None),
                        padded_leg_launches={
                            "16a": sl16a["stencil_launches"]},
                        padded_leg_max_abs_err=max(
                            r["max_abs_err"] for r in rows16a),
                        sharded_leg_launches=sharded2,
                        sharded_leg_max_abs_err=max(
                            (r["max_abs_err"] for r in rows17),
                            default=None)),
        main_path_entry(k3, rows3, sl3["stencil_launches"]
                        + sl11c["stencil_launches"]
                        + res16b["stencil_launches"],
                        "pynama_tpu/ops/pallas_stencil.py:218",
                        out["stencil3d_v1_launches"],
                        also_replaces=["pynama_tpu/ops/pallas_stencil.py:310"],
                        ws_leg_launches={"11c": sl11c["stencil_launches"]},
                        padded_leg_launches={
                            "16b": res16b["stencil_launches"]},
                        padded_leg_max_abs_err=max(
                            r["max_abs_err"] for r in rows16b)),
        breakdown,
    ]}
    out.update(phase_s=phase_s, allocated_after_gib=mem_after,
               device=torch.cuda.get_device_name(0),
               nvidia_smi=smi)
    print(json.dumps({"results": out}), flush=True)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
