"""Distributed Navier-Stokes stepping: the KLE + transport + BS5(4)
machinery of a set-up problem, run by every rank on its slab or pencil.

Port of pynama_tpu/parallel/sharded_problem.py on torch.distributed
(one process per rank, parallel/slab.py): the box mesh is partitioned
into slabs (n_dev an int) or N-D pencils (n_dev a tuple, e.g. (2, 4)
over the two slowest grid axes); every elemental operator apply is
rank-local with a one-plane halo exchange per partitioned axis; CG dot
products and RK error norms are owned-weight local sums, all-reduced.

Each rank's subdomain is itself a box grid, so the local apply is the
same blocked stencil contraction the single-device path runs
(StructuredElementOp.apply_blocked, the CUDA kernels on the card): its
phantom-cell corrections make the local apply exactly the sum over local
elements, and the interface planes' partial sums are completed by
sequential per-axis halo exchanges (the second axis' exchange carries
the first's corner contributions). The blocked layout super-blocks on
the LOCAL element counts. The problem is set up whole on every rank, as
the reference's single controller does, on that rank's device; a rank's
tensors carry no device axis. Works for the single-mask FreeSlip
problems and the dual-mask no-slip/free-slip cavity solve; with the
problem's multigrid in the problem's dtype on a slab, the KLE solves are
preconditioned by the distributed V-cycle (parallel/dist_mg.py), else by
Jacobi.
"""

import numpy as np
import torch

from pynama_tpu_torch.kle import v_tens_v
from pynama_tpu_torch.ops import conv
from pynama_tpu_torch.ops.structured import (StructuredElementOp,
                                             pick_super_factor)
from pynama_tpu_torch.parallel.dist_mg import (build_dist_mg, make_minv,
                                               masked_corrections)
from pynama_tpu_torch.parallel.slab import (GridDecomposition, RankGrid,
                                            halo_sum_blocked_axis,
                                            make_pdot)
from pynama_tpu_torch.solvers.cg import cg_solve
from pynama_tpu_torch.solvers.rk import (make_attempt_host_stepper,
                                         make_bs5_scan_attempt,
                                         make_bs5_stepper,
                                         make_chunk_controller,
                                         make_ws_state, ws_aux_vel)


def _host(x):
    """A tensor or array as a flat numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)


class ShardedNSProblem:
    """Slab/pencil-distributed wrapper around a set-up box-mesh problem.

    n_dev: int n for an n-slab over the last mesh axis, or a tuple
    (p0, p1, ...) partitioning the slowest grid axes over an N-D rank
    grid (p0 slices grid axis 0 = the last mesh axis, p1 the next, ...).
    group: the torch.distributed process group of prod(pgrid) ranks
    (None: the default group, which must be initialised); rank r holds
    the block at np.unravel_index(r, pgrid).
    """

    def __init__(self, problem, n_dev, group=None):
        self.p = problem
        pgrid = (n_dev,) if isinstance(n_dev, (int, np.integer)) \
            else tuple(int(x) for x in n_dev)
        self.pgrid = pgrid
        self.naxes = len(pgrid)
        self.n_dev = int(np.prod(pgrid))
        self.slab = GridDecomposition(problem.mesh, pgrid)
        self.ranks = RankGrid(pgrid, group)
        sl, here = self.slab, self.ranks.coords
        m = problem.mesh
        dim, dim_w, dim_s = m.dim, m.dim_w, m.dim_s
        N = m.ngl

        # local ops: the same elemental matrices on the subdomain's box,
        # super-blocked on the LOCAL nelem (all ranks share it)
        sysm, ops = problem.system, problem.operators
        sb = pick_super_factor(tuple(sl.local_nelem), N, dim)

        def lop(op, k_in, k_out):
            return StructuredElementOp(op.A, N, sl.local_nelem,
                                       sl.local_npts, k_in, k_out, sb=sb)

        self.K_op = lop(sysm.K, dim, dim)
        self.Rw_op = lop(sysm.Rw, dim_w, dim)
        self.Curl_op = lop(ops.Curl, dim, dim_w)
        self.SrT_op = lop(ops.SrT, dim, dim_s)
        self.Div_op = lop(ops.DivSrT, dim_s, dim)
        self.eff_ngl = self.K_op.eff_ngl  # local blocked-layout period + 1
        eff = self.eff_ngl

        def to_solver(x_global, k):
            """Global field (any layout, host or device) -> this rank's
            local blocked numpy array."""
            g = sl.to_local_grid(_host(x_global), k)[here]
            return conv.to_blocked_np(g, eff)

        def weight_solver(w_global, k):
            """Division weights in the blocked layout, pad slots = 1."""
            pm = conv.pad_mask(eff, sl.local_grid_shape(k)[:-1], k)
            return to_solver(w_global, k) + (1.0 - pm)

        self._to_solver = to_solver
        arr = self._tensor
        self.diag_K = arr(to_solver(sysm.diag_K, dim))
        self.w_curl = arr(weight_solver(ops.w_curl, dim_w))
        self.w_srt = arr(weight_solver(ops.w_srt, dim_s))
        self.w_div = arr(weight_solver(ops.w_div, dim))
        self.mask = arr(to_solver(problem.free_mask, dim))
        fm_fs = getattr(problem, "free_mask_fs", None)
        self.mask_fs = (arr(to_solver(fm_fs, dim)) if fm_fs is not None
                        else None)
        self.own_v = arr(self._owned(dim))
        self.own_w = arr(self._owned(dim_w))
        # coords stay grid-shaped: analytic BC fns take (N, dim) points
        self.coords = arr(sl.to_local_grid(_host(m.coords), dim)[here])

        # BC value providers: a static field or an analytic function of
        # (coords, t)
        self.vel_fn = getattr(problem, "vel_fn", None)
        self.vort_fn = getattr(problem, "vort_fn", None)
        self.u_bc = (arr(to_solver(problem._unblk(problem._solver_bc(0.0)),
                                   dim))
                     if self.vel_fn is None else None)
        bcw = getattr(problem, "bc_vort_mask", None)
        self.bc_vort_mask = (arr(to_solver(bcw, dim_w)) if bcw is not None
                             else None)
        self.n_vort_global = m.n_nodes * dim_w
        self.pdot = make_pdot(self.own_v, self.ranks)

        # distributed multigrid: the same V-cycle as single-device (slab
        # only); a multigrid in another dtype (the float32 inner solves
        # of a refined run) leaves Jacobi-CG
        self._dmg = None
        mg = getattr(problem, "mg", None)
        if (mg is not None and self.naxes == 1
                and mg.dtype == problem.dtype):
            self._dmg = build_dist_mg(mg, self)
        # does the GLOBAL solve mask free boundary dofs? (the level-0
        # blocked-transfer gate of dist_mg.make_minv)
        npg = tuple(reversed(m.npts))

        def frees(mask):
            return conv.mask_frees_boundary(
                _host(mask).reshape(npg + (dim,)), N, npg)

        self._bfree = frees(problem.free_mask)
        self._bfree_fs = frees(fm_fs) if fm_fs is not None else True
        self._minvs = self._make_minvs()
        # the K corrections each mask's operand can make nonzero
        self._kcorr = masked_corrections(self.K_op, self.mask, self.ranks)
        self._kcorr_fs = (masked_corrections(self.K_op, self.mask_fs,
                                             self.ranks)
                          if self.mask_fs is not None else None)

    def _tensor(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=self.p.dtype,
                               device=self.p.device)

    def _owned(self, k):
        """Owned-dof weights in the blocked layout (pad slots 0)."""
        w = self.slab.owned_grid_weights(k)[self.ranks.coords]
        return conv.to_blocked_np(w, self.eff_ngl)

    def _make_minvs(self):
        """(free-slip mask's, final mask's) V-cycle, or (None, None)."""
        if self._dmg is None:
            return (None, None)
        meta, local, repl = self._dmg
        fin = make_minv(meta, local, repl, self.mask, self.ranks,
                        fine_boundary_free=self._bfree)
        fs = (make_minv(meta, local, repl, self.mask_fs, self.ranks,
                        fine_boundary_free=self._bfree_fs)
              if self.mask_fs is not None else None)
        return (fs, fin)

    # ------------------------------------------------------------------
    def shard(self, x_global, k):
        """Global field (host or device, any layout) -> this rank's
        blocked local tensor."""
        return self._tensor(self._to_solver(x_global, k))

    def unshard(self, x_loc, k):
        """All-gather every rank's blocked local tensor -> the global
        flat numpy vector, on every rank."""
        npg = tuple(self.slab.local_grid_shape(k)[:-1])
        parts = [conv.from_blocked(x, self.eff_ngl, npg).cpu().numpy()
                 for x in self.ranks.all_gather(x_loc)]
        stacked = np.stack(parts).reshape(self.pgrid + parts[0].shape)
        return self.slab.from_local_grid(stacked)

    # ------------------------------------------------------------------
    def _halo(self, y):
        dim = self.p.mesh.dim
        for j in range(self.naxes):
            y = halo_sum_blocked_axis(y, self.eff_ngl - 1, dim, j,
                                      self.ranks)
        return y

    def _apply(self, op, x, corrections=True):
        """Local element apply + halo completion, in the blocked layout
        (``corrections`` as StructuredElementOp.apply_blocked's)."""
        return self._halo(op.apply_blocked(x, corrections=corrections))

    def _grid_to_solver(self, g):
        return conv.to_blocked(g, self.eff_ngl)

    def _local_fns(self, kle_rtol=None, kle_maxiter=None):
        """This rank's transport RHS ``rhs(t, vort, vel_ws) -> (f,
        aux)`` (blocked local tensors; aux a velocity, or the dual-mask
        (raw free-slip, final) pair)."""
        p = self.p
        rtol = kle_rtol if kle_rtol is not None else p.kle_rtol
        maxiter = kle_maxiter if kle_maxiter is not None else p.kle_maxiter
        dim, dim_w, dim_s = p.dim, p.dim_w, p.dim_s
        mu, rho = p.mu, p.rho
        diag, pdot = self.diag_K, self.pdot
        minv_fs, minv_fin = self._minvs

        def solve_masked(mask, corr, vort, u_bc, x0, minv):
            bc = (1.0 - mask) * u_bc
            b = mask * (self._apply(self.Rw_op, vort)
                        - self._apply(self.K_op, bc)) + bc
            m_inv = minv if minv is not None \
                else 1.0 / (mask * diag + (1.0 - mask))

            def A(x):
                return mask * self._apply(self.K_op, mask * x, corr) \
                    + (1.0 - mask) * x

            res = cg_solve(A, b, x0=mask * x0 + bc, m_inv=m_inv, rtol=rtol,
                           maxiter=maxiter, dot=pdot)
            p.cg_iters.append(res.iters)
            return res.x

        def curl(u):
            return self._apply(self.Curl_op, u) / self.w_curl

        def points(t, fn, k):
            pts = self.coords.reshape(-1, dim)
            g = fn(pts, p.nu, t).reshape(self.coords.shape[:-1] + (k,))
            return self._grid_to_solver(g)

        def transport_rhs(t, vort, vel_ws):
            u_bc = (self.u_bc if self.vel_fn is None
                    else points(t, self.vel_fn, dim))
            bcw = self.bc_vort_mask
            if self.vort_fn is not None and bcw is not None:
                vort = vort * (1.0 - bcw) \
                    + points(t, self.vort_fn, dim_w) * bcw
            if self.mask_fs is not None:
                # per-system warm starts (NoSlipProblem._kle_solve_aux)
                ws_fs, ws_fin = (vel_ws if isinstance(vel_ws, tuple)
                                 else (vel_ws, vel_ws))
                raw_fs = solve_masked(self.mask_fs, self._kcorr_fs, vort,
                                      u_bc, ws_fs, minv_fs)
                fsfree = self.mask_fs - self.mask
                vel_fs = raw_fs * (1.0 - fsfree) + u_bc * fsfree
                vel = solve_masked(self.mask, self._kcorr, curl(vel_fs),
                                   u_bc, ws_fin, minv_fin)
                aux_next = (raw_fs, vel)
            else:
                vel = solve_masked(self.mask, self._kcorr, vort, u_bc,
                                   vel_ws, minv_fin)
                aux_next = vel
            s = 2.0 * mu * (self._apply(self.SrT_op, vel) / self.w_srt) \
                - rho * v_tens_v(vel, dim)
            r = (self._apply(self.Div_op, s) / self.w_div) / rho
            return curl(r), aux_next

        return transport_rhs

    def _wlte_norm(self):
        """The RK error norm over owned real dofs, all-reduced."""
        ow, n_glob = self.own_w, self.n_vort_global
        ranks = self.ranks

        def wlte_norm(err, y_old, y_new, a, r):
            wgt = a + r * torch.maximum(torch.abs(y_old), torch.abs(y_new))
            e = err / wgt
            s = ranks.all_reduce(torch.sum(e * e * ow))
            return torch.sqrt(s / n_glob)

        return wlte_norm

    def _start(self):
        """(w, vel, t, dt, t_end) at the problem's start."""
        p = self.p
        w = self.shard(p.initial_vorticity(), p.dim_w)
        vel = self.shard(np.zeros(p.mesh.n_nodes * p.dim), p.dim)
        return w, vel, p.t_start, p.dt0, p.t_end

    # ------------------------------------------------------------------
    def build_step(self, kle_rtol=None, kle_maxiter=None, atol=None,
                   rtol=None):
        """One accepted adaptive BS5(4) step, ``step(w, t, dt, vel, f1,
        t_end) -> StepResult`` (rk.make_bs5_stepper, the distributed
        wlte norm)."""
        p = self.p
        return make_bs5_stepper(
            self._local_fns(kle_rtol, kle_maxiter),
            atol=atol if atol is not None else p.ts_atol,
            rtol=rtol if rtol is not None else p.ts_rtol,
            wlte_norm=self._wlte_norm(), max_dt=p.ts_max_dt)

    def build_rhs(self, kle_rtol=None, kle_maxiter=None):
        """The distributed transport RHS ``rhs(w, vel_ws, t) -> (f,
        aux)``, for the initial FSAL derivative and one-off evaluations."""
        fn = self._local_fns(kle_rtol, kle_maxiter)
        return lambda w, vel, t: fn(t, w, vel)

    def build_attempt(self, kle_rtol=None, kle_maxiter=None, atol=None,
                      rtol=None, chunk=1, max_dt=None, ws_extrapolate=False):
        """BS5(4) attempts: chunk=1 gives rk.make_bs5_scan_attempt's
        ``(w, t, dt, vel_aux, f1) -> (y5, f_new, wlte, aux)``; chunk=k>1
        rk.make_chunk_controller's ``(w, t, dt, vel_aux, f1, t_end) ->
        (y, t, dt, aux, f1, n_acc, wlte)`` (k attempts with the
        accept/reject + dt controller between them). ws_extrapolate: the
        aux is the rk.make_ws_state slot history."""
        p = self.p
        attempt = make_bs5_scan_attempt(
            self._local_fns(kle_rtol, kle_maxiter),
            atol=atol if atol is not None else p.ts_atol,
            rtol=rtol if rtol is not None else p.ts_rtol,
            wlte_norm=self._wlte_norm(), ws_extrapolate=ws_extrapolate)
        if chunk == 1:
            return attempt
        return make_chunk_controller(attempt, chunk, max_dt=max_dt)

    # ------------------------------------------------------------------
    def run_staged(self, max_steps=None, callback=None, kle_rtol=None,
                   kle_maxiter=None):
        """Distributed transient run, the production stepping: a host dt
        controller around one BS5 attempt (``ts-chunk`` > 1: around
        chunks of attempts), with the ws slot history under
        ``kle-ws-extrapolate``. callback(n, t, dt, w, vel) after each
        step (chunk). Returns (w_local, t, n)."""
        p = self.p
        rhs = self._local_fns(kle_rtol, kle_maxiter)
        chunk = int(p.config.get("ts-chunk", 1))
        ws = bool(p.kle_ws_extrapolate)
        attempt = self.build_attempt(kle_rtol, kle_maxiter, chunk=chunk,
                                     max_dt=p.ts_max_dt, ws_extrapolate=ws)
        if chunk == 1:
            step = make_attempt_host_stepper(attempt, max_dt=p.ts_max_dt)
        w, vel, t, dt, t_end = self._start()
        f1, vel = rhs(t, w, vel)
        if ws:
            vel = make_ws_state(vel, t)

        n = 0
        steps = max_steps if max_steps is not None else p.max_steps
        stall = 0
        while t < t_end - 1e-14 and n < steps:
            if chunk == 1:
                res = step(w, t, dt, vel, f1, t_end)
                w, t, dt, vel, f1 = (res.y, res.t, res.dt_next, res.aux,
                                     res.f_new)
                n += 1
            else:
                w, t, dt, vel, f1, n_acc, _ = attempt(w, t, dt, vel, f1,
                                                      t_end)
                n += n_acc
                stall = stall + 1 if n_acc == 0 else 0
                if stall >= 12:
                    raise RuntimeError(
                        "BS5 chunk made no progress 12 chunks in a row")
            if callback is not None:
                callback(n, t, dt, w, ws_aux_vel(vel) if ws else vel)
        return w, t, n

    def run(self, max_steps=None, callback=None):
        """Distributed transient run, one accepted step per build_step
        call. The first step warm-starts from zero velocities, as the
        reference's does (its initial RHS keeps only the derivative).
        callback(n, t, dt, w, vel) after each step. Returns (w_local, t,
        n)."""
        p = self.p
        step = self.build_step()
        w, vel, t, dt, t_end = self._start()
        if self.mask_fs is not None:
            vel = (vel, vel)  # per-system warm-start pair (dual-mask)
        f1, _ = self.build_rhs()(w, vel, t)

        n = 0
        steps = max_steps if max_steps is not None else p.max_steps
        while t < t_end - 1e-14 and n < steps:
            res = step(w, t, dt, vel, f1, t_end)
            w, t, dt, vel, f1 = res.y, res.t, res.dt_next, res.aux, res.f_new
            n += 1
            if callback is not None:
                callback(n, t, dt, w, vel)
        return w, t, n
