"""Distributed Navier-Stokes stepping on unstructured meshes:
element-partitioned data parallelism on torch.distributed.

Port of pynama_tpu/parallel/unstructured.py, the general-mesh
counterpart of the slab path (parallel/sharded_problem.py). The cells
are split into contiguous chunks, one per rank, and every elemental
operator apply is

    y = all_reduce_sum(scatter(A_chunk @ gather(x, chunk)))

with the state vectors replicated on every rank. One process per rank
(parallel/launch.py) takes the place of the reference's shard_map over a
device mesh, and one ``dist.all_reduce`` (SUM) of the full-length output
takes the place of its ``psum``. Masks, weights, CG dot products and the
BS5(4) controller act on the replicated vectors and need no collective,
so a run's all-reduces are exactly its elemental applies
(``counts["all_reduce"]``).

There is no padding. The reference pads its chunks to one size with zero
matrices scattering into dof 0, because shard_map needs uniform shapes.
Here each rank runs its own ElementOp (ops/assembly.py: the gather, one
GEMM or a bmm, the contributor-table scatter) over the cells it owns:
ceil(E / n_dev) of them, fewer on the last ranks, or none, and a rank
with none joins every all-reduce with a zero vector. A shared elemental
matrix stays shared.

Every rank sets the problem up whole on its own device (cuda:r under
NCCL, the CPU under gloo), as the reference's single controller does.
Box problems are taken too: their grid-shaped masks and fields are read
flat, in node order, which is the order of ``mesh.cell_dofs``.
"""

import numpy as np
import torch
import torch.distributed as dist

from pynama_tpu_torch.kle import v_tens_v
from pynama_tpu_torch.ops.assembly import ElementOp
from pynama_tpu_torch.parallel.slab import RankGrid
from pynama_tpu_torch.solvers.cg import cg_solve
from pynama_tpu_torch.solvers.rk import make_bs5_stepper


def cell_range(n_cells, n_dev, rank):
    """[lo, hi): the cells of ``rank``, ceil(n_cells / n_dev) a rank in
    order (the reference's chunk without its padding rows)."""
    e_loc = -(-n_cells // n_dev)
    lo = min(rank * e_loc, n_cells)
    return lo, min(lo + e_loc, n_cells)


def chunk_tables(A, in_dofs, out_dofs, n_dev, rank):
    """The rows of (A, in_dofs, out_dofs) that ``rank`` owns (numpy
    arrays or tensors): batched A (E, out_k, in_k) is cut to the chunk,
    a shared (out_k, in_k) A stays whole."""
    lo, hi = cell_range(len(in_dofs), n_dev, rank)
    return (A if A.ndim == 2 else A[lo:hi]), in_dofs[lo:hi], out_dofs[lo:hi]


class ShardedUnstructuredProblem:
    """Element-partitioned wrapper around a set-up problem (a Gmsh mesh,
    or a box mesh read through its cell dofs).

    group: the torch.distributed process group of n_dev ranks (None: the
    default group, which must be initialised); rank r owns the cells
    ``cell_range(E, n_dev, r)``. The state is replicated: ``run`` takes
    and returns flat vectors, the same on every rank. ``ops`` holds this
    rank's chunk ElementOps by the reference's names (K, Rw, Curl, SrT,
    Div); ``counts["all_reduce"]`` counts the applies.
    """

    def __init__(self, problem, n_dev, group=None):
        self.p = problem
        self.n_dev = int(n_dev)
        self.ranks = RankGrid((self.n_dev,), group)  # ValueError: size
        self.counts = self.ranks.counts
        backend, dev = dist.get_backend(group), problem.device
        if (backend == "nccl") != (dev.type == "cuda"):
            raise ValueError(f"a problem on {dev} in a {backend} group: set "
                             "it up on cuda:rank under NCCL, on the CPU "
                             "under gloo")
        m = problem.mesh
        dim, dim_w, dim_s = m.dim, m.dim_w, m.dim_s
        sysm, ops = problem.system, problem.operators
        rank = self.ranks.rank

        def chunk(op, k_in, k_out):
            A, ind, outd = chunk_tables(op.A, m.cell_dofs(k_in),
                                        m.cell_dofs(k_out), self.n_dev, rank)
            return ElementOp(A, self._index(ind), self._index(outd),
                             m.n_nodes * k_out)

        # the five global operators, this rank's chunk of each
        self.ops = {"K": chunk(sysm.K, dim, dim),
                    "Rw": chunk(sysm.Rw, dim_w, dim),
                    "Curl": chunk(ops.Curl, dim, dim_w),
                    "SrT": chunk(ops.SrT, dim, dim_s),
                    "Div": chunk(ops.DivSrT, dim_s, dim)}

        flat = self._flat
        self.n_vel = m.n_nodes * dim
        self.diag_K = flat(sysm.diag_K)
        self.w_curl = flat(ops.w_curl)
        self.w_srt = flat(ops.w_srt)
        self.w_div = flat(ops.w_div)
        self.mask = flat(problem.free_mask)
        fm_fs = getattr(problem, "free_mask_fs", None)
        self.mask_fs = flat(fm_fs) if fm_fs is not None else None
        bcw = getattr(problem, "bc_vort_mask", None)
        self.bc_vort_mask = flat(bcw) if bcw is not None else None
        self.coords = flat(m.coords).reshape(m.n_nodes, dim)
        self.vel_fn = getattr(problem, "vel_fn", None)
        self.vort_fn = getattr(problem, "vort_fn", None)
        # the one boundary velocity (the port's problems keep it in the
        # solver layout: _solver_bc, back to the node grid by _unblk)
        self.u_bc = (flat(problem._unblk(problem._solver_bc(0.0)))
                     if self.vel_fn is None else None)

    def _flat(self, x):
        """A tensor or array as a flat tensor in the problem's dtype on
        its device."""
        p = self.p
        if isinstance(x, torch.Tensor):
            return x.reshape(-1).to(dtype=p.dtype, device=p.device)
        return torch.as_tensor(np.asarray(x).reshape(-1), dtype=p.dtype,
                               device=p.device)

    def _index(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64),
                               device=self.p.device)

    # ------------------------------------------------------------------
    def _apply(self, name, x):
        """The global apply of operator ``name``: this rank's chunk, then
        one all-reduce of the full-length output."""
        return self.ranks.all_reduce(self.ops[name](x))

    def _local_fns(self, kle_rtol=None, kle_maxiter=None):
        """``transport_rhs(t, vort, vel_ws) -> (f, vel)`` on replicated
        flat vectors."""
        p = self.p
        rtol = kle_rtol if kle_rtol is not None else p.kle_rtol
        maxiter = kle_maxiter if kle_maxiter is not None else p.kle_maxiter
        dim, mu, rho = p.dim, p.mu, p.rho
        apply = self._apply

        def solve_masked(mask, vort, u_bc, x0):
            bc = (1.0 - mask) * u_bc
            b = mask * (apply("Rw", vort) - apply("K", bc)) + bc
            m_inv = 1.0 / (mask * self.diag_K + (1.0 - mask))

            def A(x):
                return mask * apply("K", mask * x) + (1.0 - mask) * x

            res = cg_solve(A, b, x0=mask * x0 + bc, m_inv=m_inv, rtol=rtol,
                           maxiter=maxiter)
            p.cg_iters.append(res.iters)
            return res.x

        def curl(u):
            return apply("Curl", u) / self.w_curl

        def transport_rhs(t, vort, vel_ws):
            if self.vel_fn is not None:
                u_bc = self.vel_fn(self.coords, p.nu, t).reshape(-1)
            else:
                u_bc = self.u_bc
            if self.vort_fn is not None and self.bc_vort_mask is not None:
                ew = self.vort_fn(self.coords, p.nu, t).reshape(-1)
                vort = (vort * (1.0 - self.bc_vort_mask)
                        + ew * self.bc_vort_mask)
            if self.mask_fs is not None:
                vel_fs = solve_masked(self.mask_fs, vort, u_bc, vel_ws)
                fsfree = self.mask_fs - self.mask
                vel_fs = vel_fs * (1.0 - fsfree) + u_bc * fsfree
                vel = solve_masked(self.mask, curl(vel_fs), u_bc, vel_fs)
            else:
                vel = solve_masked(self.mask, vort, u_bc, vel_ws)
            aux = 2.0 * mu * (apply("SrT", vel) / self.w_srt) \
                - rho * v_tens_v(vel, dim)
            r = (apply("Div", aux) / self.w_div) / rho
            return curl(r), vel

        return transport_rhs

    # ------------------------------------------------------------------
    def build_step(self, kle_rtol=None, kle_maxiter=None, atol=None,
                   rtol=None):
        """One accepted adaptive BS5(4) step, ``step(w, t, dt, vel, f1,
        t_end) -> StepResult`` (its first six fields are the reference's
        tuple: y, t, dt_next, aux, f_new, wlte)."""
        p = self.p
        return make_bs5_stepper(
            self._local_fns(kle_rtol, kle_maxiter),
            atol=atol if atol is not None else p.ts_atol,
            rtol=rtol if rtol is not None else p.ts_rtol)

    def _eval_rhs_once(self, w, t, vel):
        """The transport RHS at (t, w), warm-started from vel."""
        f, _ = self._local_fns()(t, w, vel)
        return f

    # ------------------------------------------------------------------
    def run(self, max_steps=None, callback=None):
        """Distributed transient run from the problem's initial vorticity
        and a zero velocity; callback(n, t, dt, w, vel) after each step.
        Returns (w flat, t, n)."""
        p = self.p
        step = self.build_step()
        w = self._flat(p.initial_vorticity())
        vel = torch.zeros(self.n_vel, dtype=p.dtype, device=p.device)
        t, dt, t_end = p.t_start, p.dt0, p.t_end
        f1 = self._eval_rhs_once(w, t, vel)

        n = 0
        steps = max_steps if max_steps is not None else p.max_steps
        while t < t_end - 1e-14 and n < steps:
            w, t, dt, vel, f1, _, _ = step(w, t, dt, vel, f1, t_end)
            n += 1
            if callback is not None:
                callback(n, t, dt, w, vel)
        return w, float(t), n
