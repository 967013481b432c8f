"""The KLE (Kinematic Laplacian Equation) system: K u = Rw w + lifting.

Port of pynama_tpu/kle.py. Uniform box meshes take the structured
operators (ops/structured.py, blocked layout, the stencil kernels);
unstructured (Gmsh) meshes take the gather/GEMM/scatter ElementOps of
ops/assembly.py on flat interleaved vectors. The full elemental
operators are kept and constraints are a per-dof mask P (1 = free,
0 = constrained):

    K_masked(u) = P K(P u) + (I-P) u                 (identity on BC rows)
    rhs         = P (Rw w - K ((I-P) u_bc)) + (I-P) u_bc
"""

import math
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from pynama_tpu_torch.device import resolve_device
from pynama_tpu_torch.elements.spectral import SpectralElement
from pynama_tpu_torch.mesh.structured import BoxMesh
from pynama_tpu_torch.ops import conv
from pynama_tpu_torch.ops.assembly import ElementOp, make_element_op
from pynama_tpu_torch.ops.structured import (StructuredElementOp,
                                             pick_super_factor)
from pynama_tpu_torch.solvers.cg import CGResult, cg_solve, sumdot


@dataclass
class KLESystem:
    """Velocity-recovery system: masked SPD solve via CG.

    K: vel->vel, Rw: vort->vel (structured operators, or ElementOps on
    flat vectors); diag_K: assembled diagonal of K (flat), diag_K_b:
    blocked layout (structured only).
    """

    K: Union[StructuredElementOp, ElementOp]
    Rw: Union[StructuredElementOp, ElementOp]
    diag_K: torch.Tensor
    diag_K_b: Optional[torch.Tensor] = None

    def apply_masked(self, u, free_mask, corrections=True):
        """corrections=False is valid only for masks that pin every
        boundary dof (conv.mask_frees_boundary False), decided on the
        host when the caller is set up; an ElementOp (flat ``u``) has no
        corrections and ignores it."""
        K = self.K
        if u.dim() > 1 and tuple(u.shape) == K.blocked_shape_in:
            Ku = K.apply_blocked(free_mask * u, corrections=corrections)
        else:
            Ku = K(free_mask * u)
        return free_mask * Ku + (1.0 - free_mask) * u

    def rhs(self, vort, u_bc, free_mask):
        """P (Rw w - K (I-P) u_bc) + (I-P) u_bc."""
        bc_part = (1.0 - free_mask) * u_bc
        return free_mask * (self.Rw(vort) - self.K(bc_part)) + bc_part

    def jacobi_inv(self, free_mask):
        if free_mask.dim() > 1:
            if (self.diag_K_b is not None
                    and free_mask.shape == self.diag_K_b.shape):
                diag = self.diag_K_b
            else:
                diag = self.diag_K.reshape(free_mask.shape)
        else:
            diag = self.diag_K
        return 1.0 / (free_mask * diag + (1.0 - free_mask))

    def solve(self, vort, u_bc, free_mask, x0=None, rtol: float = 1e-13,
              atol: float = 0.0, maxiter: int = 20000, restarts: int = 2,
              m_inv=None, corrections=True) -> CGResult:
        """Solve the KLE for velocity given vorticity and BC values.

        ``restarts`` re-runs CG from the converged iterate with a fresh
        residual (iterative refinement).
        """
        b = self.rhs(vort, u_bc, free_mask)
        if x0 is None:
            x0 = (1.0 - free_mask) * u_bc
        else:
            x0 = free_mask * x0 + (1.0 - free_mask) * u_bc
        apply_A = partial(self.apply_masked, free_mask=free_mask,
                          corrections=corrections)
        if m_inv is None:
            m_inv = self.jacobi_inv(free_mask)
        total_iters = 0
        res = None
        for _ in range(max(1, restarts)):
            res = cg_solve(apply_A, b, x0=x0, m_inv=m_inv, rtol=rtol,
                           atol=atol, maxiter=maxiter)
            x0 = res.x
            total_iters += res.iters
        return CGResult(x=res.x, iters=total_iters, resnorm=res.resnorm)


_TINY64 = float(np.finfo(np.float64).tiny)


class IRResult(NamedTuple):
    """CGResult's fields, and the refinement rounds taken."""
    x: torch.Tensor
    iters: int
    resnorm: torch.Tensor
    rounds: int


def solve_ir(sys64: KLESystem, sys32: KLESystem, vort, u_bc, free_mask,
             free_mask32, x0=None, rtol: float = 1e-8, maxiter: int = 4000,
             max_rounds: int = 4, inner_rtol: float = 1e-4,
             adaptive_inner: bool = True, m_inv32=None,
             corrections=True) -> IRResult:
    """Mixed-precision iterative refinement: a TRUE float64 residual
    from float32 inner solves.

    Each round forms the defect r = b - K x with one float64 apply,
    solves K d = r by float32 CG (``m_inv32``: the float32 V-cycle;
    None: Jacobi of ``sys32``), and adds d to the float64 iterate, until
    ||r|| <= rtol ||b|| or ``max_rounds`` rounds. Plain float32 CG stops
    near a true relative residual of 1e-6 however tight its tolerance;
    this reaches the 1e-8 of float64 direct solves.

    adaptive_inner: each round asks the inner solve for 0.3 times the
    reduction still needed, clipped to [inner_rtol, max(5e-2,
    inner_rtol)] and rounded to float32, computed on the host from the
    round's one read of ||r||^2. A NaN residual ends the loop at once.

    vort, u_bc, free_mask and x0 are float64 (blocked layout),
    free_mask32 the same mask in float32; ``corrections`` as in
    KLESystem.apply_masked, for both applies. Port of
    pynama_tpu/kle.py solve_ir, whose lax.while_loop over rounds is a
    host loop here. ``iters`` is the total of the inner CG iterations,
    ``resnorm`` the true float64 residual norm.
    """
    b = sys64.rhs(vort, u_bc, free_mask)
    if x0 is None:
        x = (1.0 - free_mask) * u_bc
    else:
        x = free_mask * x0 + (1.0 - free_mask) * u_bc
    if m_inv32 is None:
        m_inv32 = sys32.jacobi_inv(free_mask32)

    def apply32(v):
        return sys32.apply_masked(v, free_mask32, corrections)

    r = b - sys64.apply_masked(x, free_mask, corrections)
    rr = sumdot(r, r)
    bb_host, rr_host = torch.stack([sumdot(b, b), rr]).tolist()
    tol2 = rtol**2 * bb_host
    rounds = iters = 0
    while rr_host > tol2 and rounds < max_rounds:
        inner_t = inner_rtol
        if adaptive_inner:
            need = math.sqrt(tol2 / max(rr_host, _TINY64))
            inner_t = float(np.float32(
                min(max(0.3 * need, inner_rtol), max(5e-2, inner_rtol))))
        d = cg_solve(apply32, r.to(torch.float32), m_inv=m_inv32,
                     rtol=inner_t, maxiter=maxiter)
        x = x + d.x.to(x.dtype)
        r = b - sys64.apply_masked(x, free_mask, corrections)
        rr = sumdot(r, r)
        rr_host = float(rr)
        rounds += 1
        iters += d.iters
    return IRResult(x=x, iters=iters, resnorm=torch.sqrt(rr), rounds=rounds)


@dataclass
class ProjectionOperators:
    """Mass-lumped nodal projection operators Curl, SrT, DivSrT: each an
    operator apply followed by division with the lumped weights."""

    Curl: Union[StructuredElementOp, ElementOp]
    SrT: Union[StructuredElementOp, ElementOp]
    DivSrT: Union[StructuredElementOp, ElementOp]
    w_curl: torch.Tensor   # (n_nodes*dim_w,)
    w_srt: torch.Tensor    # (n_nodes*dim_s,)
    w_div: torch.Tensor    # (n_nodes*dim,)
    # blocked weights (pad slots = 1)
    wb_curl: Optional[torch.Tensor] = None
    wb_srt: Optional[torch.Tensor] = None
    wb_div: Optional[torch.Tensor] = None

    def _w(self, w, wb, out):
        if out.dim() == 1:
            return w
        if wb is not None and out.shape == wb.shape:
            return wb
        return w.reshape(out.shape)

    def curl(self, vel):
        out = self.Curl(vel)
        return out / self._w(self.w_curl, self.wb_curl, out)

    def strain_rate(self, vel):
        out = self.SrT(vel)
        return out / self._w(self.w_srt, self.wb_srt, out)

    def div_srt(self, s):
        out = self.DivSrT(s)
        return out / self._w(self.w_div, self.wb_div, out)


def v_tens_v(vel, dim):
    """Pointwise symmetric u (x) u in dim_s interleaved components.

    2D: [vx^2, vx vy, vy^2]; 3D adds [vy vz, vz^2, vz vx]. Flat
    interleaved, (..., dim) grid, or blocked (..., P^dim*dim).
    """
    flat = vel.dim() == 1
    if flat:
        v = vel.reshape(-1, dim)
    elif vel.shape[-1] != dim:  # blocked: (..., nsub*dim) -> (..., nsub, dim)
        nsub = vel.shape[-1] // dim
        out = v_tens_v(vel.reshape(vel.shape[:-1] + (nsub, dim)), dim)
        return out.reshape(vel.shape[:-1] + (nsub * out.shape[-1],))
    else:
        v = vel
    c = lambda i: v[..., i]  # noqa: E731
    if dim == 2:
        comps = [c(0) * c(0), c(0) * c(1), c(1) * c(1)]
    else:
        comps = [c(0) * c(0), c(0) * c(1), c(1) * c(1),
                 c(1) * c(2), c(2) * c(2), c(2) * c(0)]
    out = torch.stack(comps, dim=-1)
    return out.reshape(-1) if flat else out


def ns_rhs(system_ops: ProjectionOperators, vel, mu, rho, dim):
    """Vorticity transport RHS: Curl(Div(2 mu S - rho u(x)u) / rho)."""
    aux = 2.0 * mu * system_ops.strain_rate(vel)
    aux = aux - rho * v_tens_v(vel, dim)
    r = system_ops.div_srt(aux) / rho
    return system_ops.curl(r)


# ----------------------------------------------------------------------
# builders
# ----------------------------------------------------------------------
def _per_cell(fn, corners, chunk=256):
    """fn(corners) of a batch of cells (elem.kle_matrices or
    kle_operators), evaluated over chunks of cells by torch's number of
    host threads and concatenated: numpy's einsum releases the GIL, and
    each cell's matrices are the same bits whatever the batch."""
    from concurrent.futures import ThreadPoolExecutor

    parts = [corners[i:i + chunk] for i in range(0, len(corners), chunk)]
    with ThreadPoolExecutor(max(1, min(len(parts),
                                       torch.get_num_threads()))) as pool:
        outs = list(pool.map(fn, parts))
    return tuple(np.concatenate(a) for a in zip(*outs))


def _structured(mesh):
    """Whether the mesh takes the structured (blocked stencil) operators:
    a uniform box mesh; anything else takes ElementOps."""
    return isinstance(mesh, BoxMesh) and mesh.uniform


def _structured_op_factory(mesh, dtype, device):
    device = resolve_device(device)
    sb = pick_super_factor(tuple(mesh.nelem), mesh.ngl, mesh.dim)

    def sop(A, k_in, k_out):
        return StructuredElementOp(
            A=torch.as_tensor(np.asarray(A), dtype=dtype, device=device),
            ngl=mesh.ngl, nelem=tuple(mesh.nelem), npts=tuple(mesh.npts),
            k_in=k_in, k_out=k_out, sb=sb,
        )

    return sop


def build_kle_system(mesh, elem: SpectralElement, dtype=torch.float64,
                     device=None):
    """The matrix-free KLE system (device None: the card): structured
    operators on a uniform box mesh, per-element ElementOps (batched
    elemental matrices of each cell's geometry) otherwise."""
    dim, dim_w = mesh.dim, mesh.dim_w
    if not _structured(mesh):
        device = resolve_device(device)
        vdofs = mesh.cell_dofs(dim)
        K_el, Rw_el, _ = _per_cell(elem.kle_matrices, mesh.cell_corners)
        n_vel = mesh.n_nodes * dim
        K = make_element_op(K_el, vdofs, vdofs, n_vel, dtype, device)
        Rw = make_element_op(Rw_el, mesh.cell_dofs(dim_w), vdofs, n_vel,
                             dtype, device)
        return KLESystem(K=K, Rw=Rw, diag_K=K.diagonal())
    sop = _structured_op_factory(mesh, dtype, device)
    K_el, Rw_el, _ = elem.kle_matrices(mesh.cell_corners[0])
    K = sop(K_el, dim, dim)
    Rw = sop(Rw_el, dim_w, dim)
    diag = K.diagonal()
    gshape = tuple(reversed(mesh.npts)) + (dim,)
    return KLESystem(K=K, Rw=Rw, diag_K=diag,
                     diag_K_b=K.to_blocked(diag.reshape(gshape)))


def build_operators(mesh, elem: SpectralElement, dtype=torch.float64,
                    device=None):
    """The nodal projection operators (device None: the card); blocked
    weights only on a uniform box mesh."""
    device = resolve_device(device)
    dim, dim_w, dim_s = mesh.dim, mesh.dim_w, mesh.dim_s
    n = mesh.n_nodes
    structured = _structured(mesh)
    if structured:
        sop = _structured_op_factory(mesh, dtype, device)
        SrT_el, Div_el, Curl_el, wvec_el = elem.kle_operators(
            mesh.cell_corners[0])
        wvec_el = np.broadcast_to(wvec_el, (mesh.n_cells, elem.nnode))
        Curl = sop(Curl_el, dim, dim_w)
        SrT = sop(SrT_el, dim, dim_s)
        Div = sop(Div_el, dim_s, dim)
    else:
        vdofs = mesh.cell_dofs(dim)
        wdofs = mesh.cell_dofs(dim_w)
        sdofs = mesh.cell_dofs(dim_s)
        SrT_el, Div_el, Curl_el, wvec_el = _per_cell(elem.kle_operators,
                                                     mesh.cell_corners)
        Curl = make_element_op(Curl_el, vdofs, wdofs, n * dim_w, dtype,
                               device)
        SrT = make_element_op(SrT_el, vdofs, sdofs, n * dim_s, dtype,
                              device)
        Div = make_element_op(Div_el, sdofs, vdofs, n * dim, dtype, device)

    # assembled lumped node weights, then expanded per dof family
    w_node = np.zeros(n)
    np.add.at(w_node, np.asarray(mesh.cell2node).reshape(-1),
              np.asarray(wvec_el).reshape(-1))

    def expand(k):
        return torch.as_tensor(np.repeat(w_node, k), dtype=dtype,
                               device=device)

    def expand_blocked(k):
        """Blocked weights with pad slots = 1 (division-safe)."""
        if not structured:
            return None
        eff = Curl.eff_ngl
        npg = tuple(reversed(mesh.npts))
        g = np.repeat(w_node, k).reshape(npg + (k,))
        wb = conv.to_blocked_np(g, eff)
        pm = conv.pad_mask(eff, npg, k)
        return torch.as_tensor(wb + (1.0 - pm), dtype=dtype, device=device)

    return ProjectionOperators(
        Curl=Curl, SrT=SrT, DivSrT=Div,
        w_curl=expand(dim_w), w_srt=expand(dim_s), w_div=expand(dim),
        wb_curl=expand_blocked(dim_w), wb_srt=expand_blocked(dim_s),
        wb_div=expand_blocked(dim),
    )
