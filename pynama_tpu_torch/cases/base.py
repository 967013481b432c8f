"""Problem orchestration: setup -> KLE solve -> transient run.

Port of pynama_tpu/cases/base.py for uniform 2D and 3D box meshes and
unstructured Gmsh meshes (2D quads, 3D hexes). The config schema is the
reference's YAML: name, material-properties {rho, mu}, domain {ngl,
box-mesh {nelem, lower, upper}} or domain {ngl, gmsh-file}, time-solver
{start-time, end-time, max-steps, dt0, atol, rtol, max-dt},
boundary-conditions, kle-rtol, kle-maxiter, multigrid, and the
mixed-precision refinement (kle-refine, kle-inner-rtol,
kle-adaptive-inner: float64 state, float32 multigrid-CG inner solves,
kle.solve_ir; ignored under float32, as in the reference) and
kle-ws-extrapolate (cross-step warm-start extrapolation,
solvers/rk.py make_ws_state), and kle-solver (cg, or gmres for the
single-mask problems: solvers/gmres.py), unstructured-pc (schwarz, the
default, or jacobi; Gmsh meshes only). The constructor takes the command
line's ``ngl``, ``nelem`` and ``gmsh_file`` overrides. ``run`` writes
and resumes checkpoints (io/checkpoint.py, the reference's format).

On a box mesh the solver state (vorticity, velocity, CG and multigrid
internals) lives in the blocked layout of ops/conv.py; grid and flat
layouts appear only at the API boundary (solve_kle, transport_rhs and
the run's results). On a Gmsh mesh (``_blocked`` False) there is no
grid: the state is flat and interleaved (dof k*node + c) throughout, the
operators are ElementOps (ops/assembly.py) and the preconditioner is
additive Schwarz (solvers/schwarz.py); the layout converters below are
identities there.
``device=None`` means ``"cuda"``; without a card the constructor raises
unless the caller passes ``device="cpu"``.
"""

import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from pynama_tpu_torch.device import resolve_device
from pynama_tpu_torch.elements.spectral import SpectralElement
from pynama_tpu_torch.kle import (build_kle_system, build_operators, ns_rhs,
                                  solve_ir)
from pynama_tpu_torch.mesh.structured import BoxMesh
from pynama_tpu_torch.ops import conv
from pynama_tpu_torch.solvers.rk import (aux_map, make_bs5_stepper,
                                         make_ws_state, ws_aux_vel)

logger = logging.getLogger("pynama_tpu_torch")


class BaseProblem:
    """Shared setup/orchestration (box and Gmsh meshes).

    Subclasses build their numpy BC arrays in ``setup_bc`` (as
    ``self._bc_arrays``, in ``_gshape`` layout) and name the free-dof
    masks that get a preconditioner (a multigrid V-cycle, or Schwarz on a
    Gmsh mesh) in ``_mask_names``. Each array is a tensor ``name`` and, in
    the solver layout, ``name + "_b"`` (the same tensor on a Gmsh mesh).
    Under refinement each of those masks also has a float32 copy,
    ``name + "32_b"``, for the inner solves and their preconditioners.
    ``setup_s`` holds the seconds of each setup stage.
    """

    _mask_names = ()

    def __init__(self, config, dtype=torch.float64, device=None, ngl=None,
                 nelem=None, gmsh_file=None):
        """``ngl``, ``nelem`` and ``gmsh_file`` override the config's
        domain (None: the config's). A Gmsh file is read here, and its
        cells set ``dim`` (hexes: 3D, quads: 2D); ``nelem`` does not apply
        to it."""
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        self.name = config.get("name", "case")

        domain = config.get("domain", {})
        self.gmsh_file = gmsh_file or domain.get("gmsh-file")
        if self.gmsh_file:
            from pynama_tpu_torch.mesh.gmsh import read_msh

            self._gmsh_data = read_msh(self.gmsh_file)
            self.dim = 3 if self._gmsh_data.hexes is not None else 2
            self.nelem = self.lower = self.upper = None
        else:
            box = domain.get("box-mesh", domain)
            self.nelem = tuple(nelem if nelem is not None else box["nelem"])
            self.dim = len(self.nelem)
            self.lower = tuple(_eval_seq(box.get("lower", (0,) * self.dim)))
            self.upper = tuple(_eval_seq(box.get("upper", (1,) * self.dim)))
        self.ngl = int(ngl if ngl is not None else domain["ngl"])
        self.dim_w = 1 if self.dim == 2 else 3
        self.dim_s = 3 if self.dim == 2 else 6

        mat = config.get("material-properties", {"rho": 1.0, "mu": 1.0})
        self.rho = float(mat["rho"])
        self.mu = float(mat["mu"])
        self.nu = self.mu / self.rho

        ts = config.get("time-solver", {})
        self.t_start = float(ts.get("start-time", 0.0))
        self.t_end = float(ts.get("end-time", 1.0))
        self.max_steps = int(ts.get("max-steps", 1000))
        self.dt0 = float(ts.get("dt0", min(
            0.1, (self.t_end - self.t_start) / 10 or 0.1)))
        self.ts_atol = float(ts.get("atol", 1e-4))
        self.ts_rtol = float(ts.get("rtol", 1e-4))
        md = ts.get("max-dt")
        self.ts_max_dt = float(md) if md is not None else None

        self.kle_rtol = float(config.get("kle-rtol", 1e-10))
        self.kle_maxiter = int(config.get("kle-maxiter", 5000))
        # the KLE's Krylov solver: "cg", or "gmres" (restarted, with the
        # same masked system and preconditioner; FreeSlipProblem only,
        # as in the reference, and never under refinement)
        self.kle_solver = str(config.get("kle-solver", "cg")).lower()
        # mixed-precision iterative refinement (kle.solve_ir): float64
        # state and true float64 residuals, float32 inner solves
        self._refine = bool(config.get("kle-refine")) and \
            dtype == torch.float64
        self.kle_inner_rtol = float(config.get("kle-inner-rtol", 1e-4))
        self.kle_adaptive_inner = bool(config.get("kle-adaptive-inner",
                                                  True))
        # each RK stage warm-starts its KLE solve from the linear-in-time
        # extrapolation of its own slot's last two accepted solutions
        # (solvers/rk.py), at the cost of 2*(stages-1) kept velocities
        self.kle_ws_extrapolate = bool(config.get("kle-ws-extrapolate",
                                                  False))

        bc = config.get("boundary-conditions")
        if bc is not None:
            self.read_boundary_condition(bc)
        # Krylov iterations of every KLE solve, in order (host integers;
        # CG's, GMRES's under kle-solver: gmres, the inner CG's under
        # refinement), and the refinement rounds of every refined solve
        self.cg_iters = []
        self.ir_rounds = []
        self._setup_done = False
        # the solver layout: blocked on a box mesh, flat on a Gmsh mesh
        self._blocked = not self.gmsh_file

    # -- hooks ----------------------------------------------------------
    def read_boundary_condition(self, bc):
        pass

    def setup_bc(self):
        """Build numpy free-dof masks (grid layout) and BC values."""
        raise NotImplementedError

    def vel_bc(self, t):
        """Velocity on the node grid; only constrained dofs are read."""
        raise NotImplementedError

    def vort_bc(self, t, vort):
        """Clamp boundary vorticity (grid or blocked layout); none by
        default."""
        return vort

    def initial_vorticity(self):
        return torch.zeros(self._gshape(self.dim_w), dtype=self.dtype,
                           device=self.device)

    # -- setup ----------------------------------------------------------
    def setup(self):
        marks = [("start", time.perf_counter())]

        def mark(name):
            marks.append((name, time.perf_counter()))

        self.mesh = self._make_mesh()
        mark("mesh")
        self.elem = SpectralElement(self.ngl, self.dim)
        self.system = build_kle_system(self.mesh, self.elem, self.dtype,
                                       self.device)
        self.operators = build_operators(self.mesh, self.elem, self.dtype,
                                         self.device)
        if self._refine:
            self.system32 = build_kle_system(self.mesh, self.elem,
                                             torch.float32, self.device)
        mark("system")
        self.setup_bc()
        self._setup_blocked()
        mark("bc")
        self.setup_preconditioner()
        mark("preconditioner")
        self._setup_done = True
        self.setup_s = {name: tm - prev for (_, prev), (name, tm)
                        in zip(marks, marks[1:])}
        logger.info("%s: %dD ngl=%d, %d cells, %d nodes on %s (setup: %s)",
                    self.name, self.dim, self.ngl, self.mesh.n_cells,
                    self.mesh.n_nodes, self.device,
                    ", ".join(f"{k} {v:.1f}s"
                              for k, v in self.setup_s.items()))
        return self

    def _make_mesh(self):
        if not self.gmsh_file:
            return BoxMesh(nelem=self.nelem, lower=self.lower,
                           upper=self.upper, ngl=self.ngl)
        from pynama_tpu_torch.mesh.unstructured import (UnstructuredHexMesh,
                                                        UnstructuredQuadMesh)

        d = self._gmsh_data
        if d.hexes is not None:
            return UnstructuredHexMesh(d.points, d.hexes, self.ngl,
                                       boundary_quads=d.boundary_quads)
        return UnstructuredQuadMesh(d.points, d.quads, self.ngl,
                                    boundary_lines=d.boundary_lines)

    def _gshape(self, k):
        """The layout of a k-components-per-node field: the node grid
        (slowest axis first) on a box mesh, flat interleaved on a Gmsh
        mesh."""
        if not self._blocked:
            return (self.mesh.n_nodes * k,)
        return tuple(reversed(self.mesh.npts)) + (k,)

    def zero_vel(self):
        return torch.zeros(self._gshape(self.dim), dtype=self.dtype,
                           device=self.device)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _setup_blocked(self):
        """Grid and blocked tensors of the masks/BC constants, and per
        mask whether it frees boundary dofs (decided here, on the host).
        On a Gmsh mesh both names hold the one flat tensor and the
        corrections flag is unused (ElementOps have none)."""
        if self._blocked:
            self._solver_ngl = self.system.K.eff_ngl
            npg = tuple(reversed(self.mesh.npts))
        self._frees_boundary = {}
        for name, val in self._bc_arrays.items():
            t = self._tensor(val)
            setattr(self, name, t)
            blk = val
            self._frees_boundary[name] = True
            if self._blocked:
                blk = conv.to_blocked_np(val, self._solver_ngl)
                t = self._tensor(blk)
                self._frees_boundary[name] = conv.mask_frees_boundary(
                    blk, self._solver_ngl, npg)
            setattr(self, name + "_b", t)
            if self._refine and name in self._mask_names:
                setattr(self, name + "32_b", torch.as_tensor(
                    blk, dtype=torch.float32, device=self.device))

    def _blk(self, grid):
        if not self._blocked:
            return grid
        return conv.to_blocked(grid, self._solver_ngl)

    def _unblk(self, xb):
        if not self._blocked:
            return xb
        return conv.from_blocked(xb, self._solver_ngl,
                                 tuple(reversed(self.mesh.npts)))

    def _bshape(self, k):
        if not self._blocked:
            return self._gshape(k)
        return conv.blocked_shape(self._solver_ngl,
                                  tuple(reversed(self.mesh.npts)), k)

    def _wlte_norm(self):
        """RK error norm over REAL dofs: the blocked layout's zero pad
        slots must not count."""
        n_real = self.mesh.n_nodes * self.dim_w

        def norm(err, y_old, y_new, atol, rtol):
            w = atol + rtol * torch.maximum(torch.abs(y_old),
                                            torch.abs(y_new))
            e = err / w
            return torch.sqrt(torch.sum(e * e) / n_real)

        return norm

    def _is_blocked(self, x, k):
        return x.dim() > 1 and tuple(x.shape) == self._bshape(k)

    def _to_solver(self, x, k):
        """A blocked, grid or flat field of k components per node in the
        solver layout (flat on a Gmsh mesh, whatever the input's shape)."""
        if not self._blocked:
            return x.reshape(-1)
        if self._is_blocked(x, k):
            return x
        if x.dim() == 1:
            x = x.reshape(self._gshape(k))
        return self._blk(x)

    def _restorer(self, vort):
        """The map from the solver layout back to vort's layout (on a
        Gmsh mesh: flat, or (..., k) per node as vort is shaped)."""
        if not self._blocked:
            if vort.dim() == 1:
                return lambda x: x
            lead = tuple(vort.shape[:-1])
            return lambda x: x.reshape(lead + (-1,))
        if self._is_blocked(vort, self.dim_w):
            return lambda xb: xb
        if vort.dim() == 1:
            return lambda xb: self._unblk(xb).reshape(-1)
        return self._unblk

    def _kle_layout(self, vort, x0):
        """Convert solve inputs to the blocked layout; return a restorer
        to vort's layout."""
        x0_b = None if x0 is None else self._to_solver(x0, self.dim)
        return self._to_solver(vort, self.dim_w), x0_b, self._restorer(vort)

    def setup_preconditioner(self):
        """Geometric-multigrid V-cycles (one per mask), or on a Gmsh mesh
        additive Schwarz; Jacobi-CG under 'multigrid: false', on a Gmsh
        mesh under 'unstructured-pc: jacobi', or when the mesh cannot be
        coarsened. Under refinement the preconditioners serve the float32
        inner solves, so they are float32 (and the V-cycles are built
        from the float32 masks)."""
        self._minv = {}
        if not self.config.get("multigrid", True):
            return
        if not self._blocked:
            self._setup_schwarz()
            return
        from pynama_tpu_torch.solvers.multigrid import MGPreconditioner

        mgc = self.config.get("multigrid", True)
        opts = mgc if isinstance(mgc, dict) else {}
        mg = MGPreconditioner(
            self.mesh, self.elem,
            dtype=torch.float32 if self._refine else self.dtype,
            device=self.device,
            pre_smooth=int(opts.get("pre", 3)),
            post_smooth=int(opts.get("post", 3)),
            smoother=opts.get("smoother", "patch"),
            cheb_div=opts.get("cheb-div"),
            galerkin=bool(opts.get("galerkin", True)),
        )
        if not mg.usable:
            logger.warning("%s: no multigrid hierarchy for nelem=%s; KLE "
                           "solves use Jacobi-CG", self.name, self.nelem)
            return
        self.mg = mg
        suffix = "32_b" if self._refine else "_b"
        for name in self._mask_names:
            self._minv[name] = mg.build(
                getattr(self, name + suffix),
                frees_boundary=self._frees_boundary[name])

    def _setup_schwarz(self):
        """One Schwarz preconditioner per mask (solvers/schwarz.py), from
        the system's elemental K in float64 and the numpy masks."""
        if str(self.config.get("unstructured-pc", "schwarz")) != "schwarz":
            logger.info("%s: unstructured-pc=jacobi (plain Jacobi-CG)",
                        self.name)
            return
        from pynama_tpu_torch.solvers.schwarz import build_element_schwarz

        K_el = self.system.K.A.to(torch.float64).cpu().numpy()
        pc_dtype = torch.float32 if self._refine else self.dtype
        for name in self._mask_names:
            pc = build_element_schwarz(
                self.mesh, K_el, self._bc_arrays[name].reshape(-1),
                pc_dtype, device=self.device)
            if pc is not None:
                self._minv[name] = pc
                logger.info("%s: %s-patch Schwarz for %s (%d blocks of "
                            "%d dofs, coarse %d dofs)", self.name,
                            pc.patches, name, pc.n_patches, pc.block_dofs,
                            pc.coarse_dofs)

    # -- solves ----------------------------------------------------------
    def _solver_bc(self, t):
        """vel_bc in the solver layout."""
        return self._blk(self.vel_bc(t))

    def _solve(self, name, vort, u_bc, x0, rtol, maxiter, restarts):
        """One masked KLE solve with the mask ``name`` (solver layout);
        under refinement by solve_ir (``restarts`` unused)."""
        mask, corr = getattr(self, name + "_b"), self._frees_boundary[name]
        if self._refine:
            res = solve_ir(
                self.system, self.system32, vort, u_bc, mask,
                getattr(self, name + "32_b"), x0=x0, rtol=rtol,
                maxiter=maxiter, inner_rtol=self.kle_inner_rtol,
                adaptive_inner=self.kle_adaptive_inner,
                m_inv32=self._minv.get(name), corrections=corr)
            self.ir_rounds.append(res.rounds)
        else:
            res = self.system.solve(
                vort, u_bc, mask, x0=x0, rtol=rtol, maxiter=maxiter,
                restarts=restarts, m_inv=self._minv.get(name),
                corrections=corr)
        self.cg_iters.append(res.iters)
        return res

    def solve_kle(self, t, vort, x0=None):
        raise NotImplementedError

    def _kle_solve_aux(self, t, vort, vel_ws):
        vel = self.solve_kle(t, vort, x0=vel_ws)
        return vel, vel

    def transport_rhs(self, t, vort, vel_ws):
        """d(vort)/dt and the next warm-start aux (a velocity or a tuple
        of velocities). Blocked vorticity passes straight through; grid
        or flat vorticity, with its aux in the same layout, is converted
        to blocked on the way in, and the RHS and the aux come back in
        the caller's layout."""
        restore = self._restorer(vort)
        vort = self.vort_bc(t, self._to_solver(vort, self.dim_w))
        vel_ws = aux_map(lambda v: self._to_solver(v, self.dim), vel_ws)
        vel, aux = self._kle_solve_aux(t, vort, vel_ws)
        f = ns_rhs(self.operators, vel, self.mu, self.rho, self.dim)
        return restore(f), aux_map(restore, aux)

    def _aux_vel(self, aux):
        return aux[-1] if isinstance(aux, tuple) else aux

    # -- transient -------------------------------------------------------
    def run(self, callback: Optional[Callable] = None, max_steps=None,
            checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
            resume_from: Optional[str] = None):
        """Advance vorticity from t_start to t_end adaptively.

        callback(n, t, dt, vort_grid, vel_grid) runs after each accepted
        step. Returns (vort flat, t, steps); sets self.vort / self.vel.
        Under kle-ws-extrapolate the aux is the slot history, made after
        the initial RHS (which gives the aux its steady structure).
        With checkpoint_path and checkpoint_every, every checkpoint_every
        steps saves (step, t, dt, vort, vel, f1) there; resume_from
        restores them. A checkpoint keeps one velocity, the aux's last
        member, so a dual-mask problem resumes with both of its solves
        warm-started from it.
        """
        if not self._setup_done:
            raise RuntimeError("call setup() before run()")
        ws = self.kle_ws_extrapolate
        step = make_bs5_stepper(self.transport_rhs, atol=self.ts_atol,
                                rtol=self.ts_rtol,
                                wlte_norm=self._wlte_norm(),
                                max_dt=self.ts_max_dt, ws_extrapolate=ws)
        if resume_from:
            ck, t, dt, n = self._load_state(resume_from)
            vort, vel, f1 = (self._blk(ck[k]) for k in ("vort", "vel", "f1"))
            if ws:
                # the slot history needs the steady aux structure (a pair
                # for dual-mask problems): one more RHS evaluation
                _, vel = self.transport_rhs(t, vort, vel)
        else:
            vort = self._blk(self.initial_vorticity())
            vel = self._blk(self.zero_vel())
            t = self.t_start
            dt = self.dt0
            f1, vel = self.transport_rhs(t, vort, vel)
            n = 0
        if ws:
            vel = make_ws_state(vel, t)
        steps = max_steps if max_steps is not None else self.max_steps
        while t < self.t_end - 1e-14 and n < steps:
            res = step(vort, t, dt, vel, f1, self.t_end)
            vort, t, dt, vel, f1 = res.y, res.t, res.dt_next, res.aux, \
                res.f_new
            n += 1
            save = bool(checkpoint_path and checkpoint_every
                        and n % checkpoint_every == 0)
            if callback is None and not save:
                continue
            vort_g = self._unblk(vort)
            vel_g = self._unblk(self._aux_vel(ws_aux_vel(vel) if ws else vel))
            if callback is not None:
                callback(n, t, dt, vort_g, vel_g)
            if save:
                self._save_state(checkpoint_path, n, t, dt, vort_g, vel_g,
                                 self._unblk(f1))
        # public attributes stay flat (interleaved dofs) at the API boundary
        self.vort = self._unblk(vort).reshape(-1)
        self.vel = self._unblk(self.solve_kle(t, vort)).reshape(-1)
        return self.vort, float(t), n

    def _save_state(self, path, n, t, dt, vort, vel, f1, extra=None):
        """A checkpoint of grid-layout fields, copied to the host here."""
        from pynama_tpu_torch.io.checkpoint import save_checkpoint

        save_checkpoint(path, step=n, t=float(t), dt=float(dt),
                        vort=vort.reshape(-1).cpu().numpy(),
                        vel=vel.reshape(-1).cpu().numpy(),
                        f1=f1.reshape(-1).cpu().numpy(), extra=extra)

    def _load_state(self, path):
        """(checkpoint with vort, vel and f1 as grid tensors, t, dt, step)."""
        from pynama_tpu_torch.io.checkpoint import load_checkpoint

        ck = load_checkpoint(path)
        for k, comps in (("vort", self.dim_w), ("vel", self.dim),
                         ("f1", self.dim_w)):
            ck[k] = self._tensor(ck[k].reshape(self._gshape(comps)))
        return ck, ck["t"], ck["dt"], ck["step"]


class FreeSlipProblem(BaseProblem):
    """Every boundary node fully Dirichlet-constrained: one mask, one KLE
    solve per evaluation. Port of the reference's FreeSlipProblem."""

    _mask_names = ("free_mask",)

    def setup_bc(self):
        """The free-dof mask and the boundary-vorticity mask, numpy grid
        layout; subclasses add their BC values."""
        mesh = self.mesh
        mask = np.ones(mesh.n_nodes * self.dim)
        mask[mesh.node_dofs(mesh.boundary_nodes, self.dim)] = 0.0
        wmask = np.zeros(mesh.n_nodes * self.dim_w)
        wmask[mesh.node_dofs(mesh.boundary_nodes, self.dim_w)] = 1.0
        self._bc_arrays = {
            "free_mask": mask.reshape(self._gshape(self.dim)),
            "bc_vort_mask": wmask.reshape(self._gshape(self.dim_w)),
        }

    def solve_kle(self, t, vort, x0=None, rtol=None, maxiter=None,
                  restarts=1):
        """Velocity of a vorticity field (blocked, grid or flat layout;
        the result has the same layout)."""
        vort, x0, restore = self._kle_layout(vort, x0)
        res = self._solve(
            "free_mask", vort, self._solver_bc(t), x0,
            rtol if rtol is not None else self.kle_rtol,
            maxiter if maxiter is not None else self.kle_maxiter, restarts)
        return restore(res.x)

    def _solve(self, name, vort, u_bc, x0, rtol, maxiter, restarts):
        """BaseProblem._solve, or GMRES under kle-solver: gmres (which
        ignores ``restarts``); refinement comes first."""
        if self._refine or self.kle_solver != "gmres":
            return super()._solve(name, vort, u_bc, x0, rtol, maxiter,
                                  restarts)
        res = self._gmres_kle(name, vort, u_bc, x0, rtol, maxiter)
        self.cg_iters.append(res.iters)
        return res

    def _gmres_kle(self, name, vort, u_bc, x0, rtol, maxiter):
        """Restarted GMRES on the masked system of mask ``name``, in the
        blocked layout raveled, with the CG path's preconditioner: the
        mask's V-cycle, else Jacobi."""
        from pynama_tpu_torch.solvers.gmres import gmres_solve

        mask, corr = getattr(self, name + "_b"), self._frees_boundary[name]
        b = self.system.rhs(vort, u_bc, mask)
        shape = b.shape
        if x0 is None:
            x0 = (1.0 - mask) * u_bc
        else:
            x0 = mask * x0 + (1.0 - mask) * u_bc
        m_inv = self._minv.get(name)
        if m_inv is None:
            jm = self.system.jacobi_inv(mask)
            m_fn = lambda r: (jm * r.reshape(shape)).reshape(-1)  # noqa: E731
        else:
            m_fn = lambda r: m_inv(r.reshape(shape)).reshape(-1)  # noqa: E731
        res = gmres_solve(
            lambda v: self.system.apply_masked(v.reshape(shape), mask,
                                               corr).reshape(-1),
            b.reshape(-1), x0=x0.reshape(-1), m_inv=m_fn, rtol=rtol,
            maxiter=maxiter)
        return res._replace(x=res.x.reshape(shape))

    def kle_error(self, viscous_times, exact_fields):
        """||u - u_exact||_2 of KLE solves at t = tau^2 / (4 nu);
        exact_fields(t) -> (vel (N, dim), vort (N, dim_w)) tensors."""
        errors = []
        for tau in viscous_times:
            t = tau**2 / (4.0 * self.nu)
            vel_e, vort_e = exact_fields(t)
            u = self.solve_kle(t, vort_e.reshape(self._gshape(self.dim_w)),
                               rtol=1e-13, maxiter=30000, restarts=2)
            errors.append(float(torch.linalg.norm(
                u.reshape(-1) - vel_e.reshape(-1))))
        return errors


_EVAL_NAMES = {"__builtins__": {}}
_EVAL_LOCALS = {
    "pi": np.pi, "e": np.e, "sqrt": np.sqrt, "sin": np.sin, "cos": np.cos,
}


def _eval_scalar(v):
    """A YAML scalar that may be a math expression like '2*pi' (math
    names only, no builtins)."""
    if isinstance(v, str):
        return float(eval(v, _EVAL_NAMES, _EVAL_LOCALS))
    return float(v)


def _eval_seq(seq):
    return [_eval_scalar(v) for v in seq]
