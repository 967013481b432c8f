"""Geometric multigrid V-cycle preconditioner for the KLE stiffness K.

Port of pynama_tpu/solvers/multigrid.py, blocked path: the same box
re-meshed coarser per level (ratios 2/3/5, at most 5 levels; an element
count that none of them divides is padded to the next even count by a
Dirichlet-masked ghost band, a fictitious-domain jump), Galerkin coarse
operators computed on the host (K_c^el = sum_s I_s^T K_f^el I_s), a
vertex-star patch (additive Schwarz) smoother under Chebyshev, blocked
stride-m transfers with exact boundary corrections (grid-layout ones at
a padded jump), and a dense inverse on the coarsest level. Every
smoother and operator apply goes through the stencil kernel
(ops/stencil.py); the transfers are small matmul tap loops, as in the
reference.
"""

import itertools
from dataclasses import dataclass
from functools import partial
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as tnf

from pynama_tpu_torch.elements.lagrange import lagrange_basis
from pynama_tpu_torch.elements.quadrature import lobatto_points
from pynama_tpu_torch.device import resolve_device
from pynama_tpu_torch.elements.spectral import SpectralElement
from pynama_tpu_torch.kle import build_kle_system
from pynama_tpu_torch.mesh.structured import BoxMesh
from pynama_tpu_torch.ops import conv
from pynama_tpu_torch.ops.structured import (StructuredElementOp,
                                             grid_gather, grid_scatter_add,
                                             pick_super_factor)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _pad_spatial(x, pads):
    """Zero-pad the leading len(pads) axes of (..., C) by (lo, hi) each."""
    flat = (0, 0)
    for lo, hi in reversed(pads):
        flat += (lo, hi)
    return tnf.pad(x, flat)


def blocked_restrict_apply(x, Wr, m, e_lo, Bc, dim, lo_ghost=0,
                           hi_ghost=0):
    """Stride-m block restriction on super-blocked tensors.

    x: (Bf..., Cf) fine blocked (already times the blocked
    1/multiplicity weights; pad slots zero). Coarse block bc accumulates
    x[m*bc + t - e_lo] @ Wr[t] over taps t in [0, T) per axis; each axis
    is grouped into (group, residue) so every tap is a plain slice.
    lo_ghost / hi_ghost add that many coarse blocks below index 0 / past
    Bc[0] on axis 0 (ghosts first): the distributed path's margins
    (parallel/dist_mg.py).
    """
    T = Wr.shape[0]
    Bc = (Bc[0] + lo_ghost + hi_ghost,) + tuple(Bc[1:])
    n_extra = -(-T // m) + 1  # groups beyond Bc needed by the taps
    pads = []
    for a in range(dim):
        lo = e_lo + (m * lo_ghost if a == 0 else 0)
        need = m * (Bc[a] + n_extra)
        hi = need - (x.shape[a] + lo)
        if hi < 0:
            raise ValueError("fine blocked tensor larger than its groups")
        pads.append((lo, hi))
    x = _pad_spatial(x, pads)
    shape = ()
    for a in range(dim):
        shape += (Bc[a] + n_extra, m)
    x = x.reshape(shape + (x.shape[-1],))
    out = None
    for t in itertools.product(range(T), repeat=dim):
        idx = []
        for a in range(dim):
            idx += [slice(t[a] // m, Bc[a] + t[a] // m), t[a] % m]
        v = torch.matmul(x[tuple(idx) + (slice(None),)], Wr[t])
        if out is None:
            out = v
        else:
            out += v
    return out


def blocked_prolong_apply(xc, Wr, m, e_lo, Bf, dim, lo_ghost=0,
                          hi_ghost=0):
    """Adjoint of blocked_restrict_apply (before multiplicity weights).

    xc: (Bc..., Cc) coarse blocked correction with zero pad slots.
    Returns the (Bf..., Cf) fine blocked scatter; lo_ghost / hi_ghost
    add that many fine blocks below index 0 / past Bf[0] on axis 0
    (ghosts first).
    """
    T = Wr.shape[0]
    Bc = tuple(xc.shape[:dim])
    Cf = Wr.shape[-2]
    shifts = [((t - e_lo) // m, (t - e_lo) % m) for t in range(T)]
    smin = min(s for s, _ in shifts)
    smax = max(s for s, _ in shifts)
    nsl = smax - smin + 1
    slabs = {}
    for t in itertools.product(range(T), repeat=dim):
        v = torch.matmul(xc, Wr[t].transpose(-1, -2))
        rho = tuple(shifts[ta][1] for ta in t)
        v = _pad_spatial(v, [(shifts[ta][0] - smin, smax - shifts[ta][0])
                             for ta in t])
        slabs[rho] = v if rho not in slabs else slabs[rho] + v
    gshape = tuple(b + nsl - 1 for b in Bc)
    zero = None
    parts = []
    for rho in itertools.product(range(m), repeat=dim):
        if rho in slabs:
            parts.append(slabs[rho])
        else:
            if zero is None:
                zero = xc.new_zeros(gshape + (Cf,))
            parts.append(zero)
    parts = torch.stack(parts, 0).reshape((m,) * dim + gshape + (Cf,))
    perm = []
    for a in range(dim):
        perm += [dim + a, a]  # interleave (g_a, r_a)
    perm.append(2 * dim)
    full = parts.permute(perm).reshape(tuple(m * g for g in gshape) + (Cf,))
    off = -m * smin  # full index of fine block 0
    sl = (slice(off - lo_ghost, off + Bf[0] + hi_ghost),) + tuple(
        slice(off, off + Bf[a]) for a in range(1, dim)) + (slice(None),)
    return full[sl]


def _kron_all(mats):
    out = mats[0]
    for m in mats[1:]:
        out = np.kron(out, m)
    return out


def _patch_matrix(K_el, ngl, dim):
    """Exact interior vertex-star patch stiffness R_p A R_p^T (numpy).

    The patch = the 2^dim elements sharing a mesh vertex,
    (2*ngl-1)^dim nodes, assembled on a 4^dim-element local grid; one
    matrix serves every interior vertex of a uniform mesh.
    """
    P = ngl - 1
    m = BoxMesh(nelem=(4,) * dim, lower=(0,) * dim, upper=(1,) * dim,
                ngl=ngl)
    n = m.n_nodes * dim
    vd = np.asarray(m.cell_dofs(dim), dtype=np.int64)
    K_full = np.zeros((n, n))
    for e in range(m.n_cells):
        idx = vd[e]
        K_full[np.ix_(idx, idx)] += K_el
    npl = 4 * P + 1
    coords = np.stack(
        np.meshgrid(*([np.arange(npl)] * dim), indexing="ij"), axis=-1
    ).reshape(-1, dim)
    sel = np.all((coords >= P) & (coords <= 3 * P), axis=1)
    nodes = np.flatnonzero(sel)
    dofs = (nodes[:, None] * dim + np.arange(dim)[None, :]).reshape(-1)
    return K_full[np.ix_(dofs, dofs)]


def _subcell_interp_matrices(ngl, dim, ratio=2):
    """(ratio**dim, nnode, nnode): coarse-element basis at each fine
    subcell's nodes; subcell index lexicographic (x fastest)."""
    nodes, _ = lobatto_points(ngl)
    hs = []
    for part in range(ratio):
        pts = (nodes + 1.0) / ratio + (2.0 * part / ratio) - 1.0
        h, _ = lagrange_basis(nodes, pts)
        hs.append(h)
    out = []
    for s in range(ratio**dim):
        digits = []
        ss = s
        for _ in range(dim):  # x digit first
            digits.append(ss % ratio)
            ss //= ratio
        factors = [hs[digits[axis]] for axis in reversed(range(dim))]
        out.append(_kron_all(factors))
    return np.stack(out)


def coarsening_ratios(mesh, coarsest_max_dofs=1500, max_levels=5):
    """Per-jump (ratio, ne_ext), fine to coarse.

    Smallest admissible ratio of 2/3/5 first; where none divides every
    axis (and every axis has at least 3 elements) the fine level is
    extended to the next even count, ne_ext, by a ghost band at the upper
    side and halved (a padded, fictitious-domain jump). Until the coarse
    level has fewer than coarsest_max_dofs dofs; then adjacent pad-free
    jumps merge from the coarse end (product <= 8) until at most
    max_levels levels remain -- kept so hierarchies and iteration counts
    match the reference.
    """
    def dofs(nel):
        return BoxMesh(nelem=tuple(nel), lower=mesh.lower, upper=mesh.upper,
                       ngl=mesh.ngl).n_nodes * mesh.dim

    jumps = []
    ne = list(mesh.nelem)
    while True:
        for r in (2, 3, 5):
            if all(n % r == 0 and n >= r for n in ne):
                break
        else:
            if not all(n >= 3 for n in ne):
                break  # tiny: current ne is coarsest
            r = 2  # pad to the next even count and halve
        ne_ext = tuple(-(-n // r) * r for n in ne)
        jumps.append((r, ne_ext))
        ne = [n // r for n in ne_ext]
        if dofs(ne) < coarsest_max_dofs:
            break

    def padfree(i):
        ne_in = tuple(mesh.nelem) if i == 0 else tuple(
            n // jumps[i - 1][0] for n in jumps[i - 1][1])
        return jumps[i][1] == ne_in

    while len(jumps) + 1 > max_levels:
        for i in range(len(jumps) - 2, -1, -1):
            if (jumps[i][0] * jumps[i + 1][0] <= 8
                    and padfree(i) and padfree(i + 1)):
                jumps[i:i + 2] = [(jumps[i][0] * jumps[i + 1][0],
                                   jumps[i][1])]
                break
        else:
            break
    return jumps[: max_levels - 1]


@dataclass
class _Level:
    mesh: BoxMesh
    K: StructuredElementOp
    diag: torch.Tensor                      # assembled diag of K (grid)
    mask: torch.Tensor                      # Dirichlet free mask (grid)
    diag_b: Optional[torch.Tensor] = None   # blocked layout
    mask_b: Optional[torch.Tensor] = None
    mask_np: Optional[np.ndarray] = None
    # transfer to the next-coarser level (None on the coarsest)
    ratio: int = 2
    interp_k: Optional[torch.Tensor] = None  # (r^dim, nnode*d, nnode*d)
    mult_inv: Optional[torch.Tensor] = None  # grid 1/multiplicity
    mult_b: Optional[torch.Tensor] = None    # blocked 1/multiplicity
    pad_b: Optional[torch.Tensor] = None     # blocked pad mask
    # extended fine mesh of a padded (fictitious-domain) jump: the grid
    # transfers pad/crop between it and the real one (None: no pad)
    ext_mesh: Optional[BoxMesh] = None


class MGPreconditioner:
    """V-cycle preconditioner; built once per (mesh, element)."""

    def __init__(self, mesh: BoxMesh, elem: SpectralElement,
                 dtype=torch.float64, device=None, pre_smooth: int = 3,
                 post_smooth: int = 3, coarsest_max_dofs: int = 1500,
                 min_levels: int = 2, max_levels: int = 5,
                 galerkin: bool = True, smoother: str = "patch",
                 cheb_div: float = None):
        self.dim = mesh.dim
        self.dtype = dtype
        self.device = resolve_device(device)
        self.pre, self.post = pre_smooth, post_smooth
        self.cheb_div = cheb_div if cheb_div is not None else (
            16.0 if smoother == "patch" else 4.0)
        self.elem = elem
        self._tk_cache = {}
        self._tks_cache = {}
        self._lam_jacobi = None

        jumps = coarsening_ratios(mesh, coarsest_max_dofs, max_levels)
        meshes = [mesh]
        ext_meshes = []  # per jump: the extended fine mesh, or None
        for r, ne_ext in jumps:
            prev = meshes[-1]
            upper_ext = tuple(
                prev.lower[a] + ne_ext[a]
                * ((prev.upper[a] - prev.lower[a]) / prev.nelem[a])
                for a in range(self.dim))
            ext_meshes.append(
                None if tuple(ne_ext) == tuple(prev.nelem) else
                BoxMesh(nelem=ne_ext, lower=prev.lower, upper=upper_ext,
                        ngl=mesh.ngl))
            meshes.append(BoxMesh(nelem=tuple(n // r for n in ne_ext),
                                  lower=prev.lower, upper=upper_ext,
                                  ngl=mesh.ngl))
        self.ratios = [r for r, _ in jumps]
        self.usable = len(meshes) >= min_levels and (
            meshes[-1].n_nodes * mesh.dim <= coarsest_max_dofs * 2)
        if not self.usable:
            return

        interp_cache = {}

        def interp_for(r):
            if r not in interp_cache:
                interp = _subcell_interp_matrices(mesh.ngl, mesh.dim, r)
                interp_cache[r] = np.stack(
                    [np.kron(m_, np.eye(mesh.dim)) for m_ in interp])
            return interp_cache[r]

        # per-level ELEMENTAL matrices: level 0 from the element, coarser
        # levels by Galerkin RAP through the subcell injections (float64)
        K_el0, _, _ = elem.kle_matrices(mesh.cell_corners[0])
        K_els = [np.asarray(K_el0, dtype=np.float64)]
        for r in self.ratios:
            I = interp_for(r)
            Kf = K_els[-1]
            Kc = np.zeros_like(Kf)
            for s in range(I.shape[0]):
                Kc += I[s].T @ Kf @ I[s]
            K_els.append(Kc)

        def tens(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        self.levels: List[_Level] = []
        for li, m in enumerate(meshes):
            if li == 0 or not galerkin:
                sysm = build_kle_system(m, elem, dtype, self.device)
                K_op, diag_flat = sysm.K, sysm.diag_K
            else:
                K_op = StructuredElementOp(
                    A=tens(K_els[li]), ngl=m.ngl, nelem=tuple(m.nelem),
                    npts=tuple(m.npts), k_in=m.dim, k_out=m.dim,
                    sb=pick_super_factor(tuple(m.nelem), m.ngl, m.dim),
                )
                diag_flat = K_op.diagonal()
            gshape = tuple(reversed(m.npts)) + (m.dim,)
            dmask = np.ones(m.n_nodes * m.dim)
            dmask[m.node_dofs(m.boundary_nodes, m.dim)] = 0.0
            if li > 0 and tuple(m.upper) != tuple(mesh.upper):
                # coarse level of a padded jump: Dirichlet-mask the ghost
                # band beyond the original domain
                beyond = np.zeros(m.n_nodes, dtype=bool)
                for a in range(self.dim):
                    tol = 1e-9 * (m.upper[a] - m.lower[a])
                    beyond |= m.coords[:, a] > mesh.upper[a] + tol
                dmask[np.repeat(beyond, m.dim)] = 0.0
            lvl = _Level(mesh=m, K=K_op, diag=diag_flat.reshape(gshape),
                         mask=tens(dmask.reshape(gshape)),
                         mask_np=dmask.reshape(gshape))
            lvl.diag_b = K_op.to_blocked(lvl.diag)
            lvl.mask_b = K_op.to_blocked(lvl.mask)
            lvl.pad_b = conv.pad_mask_tensor(
                K_op.eff_ngl, tuple(reversed(m.npts)), self.dim,
                self.device, dtype)
            if li + 1 < len(meshes):
                lvl.ratio = self.ratios[li]
                lvl.interp_k = tens(interp_for(lvl.ratio))
                lvl.ext_mesh = ext_meshes[li]
                # fine-node multiplicity under the subcell scatter, over
                # the extended grid of a padded jump (mult_b, the blocked
                # copy, is made in build for the jumps that use it)
                em = lvl.ext_mesh if lvl.ext_mesh is not None else m
                counts = np.zeros(em.n_nodes)
                np.add.at(counts, np.asarray(em.cell2node).reshape(-1), 1.0)
                lvl.mult_inv = tens(np.repeat(1.0 / counts, m.dim).reshape(
                    tuple(reversed(em.npts)) + (m.dim,)))
            self.levels.append(lvl)

        # vertex-star additive-Schwarz smoother blocks: per-level patch
        # stiffness inverse as a footprint-5 parity kernel (grid applies)
        # and rebased onto the level's blocked layout (V-cycle applies)
        self.smoother = smoother
        self.patch_W = None
        self.patch_Wb = None
        np_dtype = _NP_DTYPES[dtype]
        if smoother == "patch":
            self.patch_W, self.patch_Wb = [], []
            for li, m in enumerate(meshes):
                if galerkin or li == 0:
                    K_lvl = K_els[li]
                else:
                    K_lvl = np.asarray(elem.kle_matrices(m.cell_corners[0])[0])
                Ap = _patch_matrix(K_lvl, mesh.ngl, self.dim)
                Wp = conv.build_patch_kernel(np.linalg.inv(Ap), mesh.ngl,
                                             self.dim, self.dim, np_dtype)
                Wb = conv.rebase_conv_kernel(Wp, self.levels[li].K.sb,
                                             self.dim, self.dim, self.dim,
                                             mesh.ngl)
                self.patch_W.append(tens(np.ascontiguousarray(Wp)))
                self.patch_Wb.append(tens(np.ascontiguousarray(Wb)))

        self.lam_max = self._estimate_lam_max()

        # dense inverse on the coarsest level (masked operator), in
        # float64 on the host: kappa(K) ~ 1e5-1e6 makes a float32
        # inverse useless
        last = self.levels[-1]
        cm = last.mesh
        n = cm.n_nodes * cm.dim
        if galerkin:
            K_el = K_els[len(self.levels) - 1]
        else:
            K_el, _, _ = elem.kle_matrices(cm.cell_corners[0])
        vd = np.asarray(cm.cell_dofs(cm.dim), dtype=np.int64)
        K_full = np.zeros((n, n))
        for e in range(cm.n_cells):
            idx = vd[e]
            K_full[np.ix_(idx, idx)] += K_el
        m64 = last.mask_np.reshape(-1)
        K_masked = (m64[:, None] * K_full * m64[None, :]) + np.diag(1.0 - m64)
        self.coarse_inv = tens(np.linalg.inv(K_masked))

    # ------------------------------------------------------------------
    def _estimate_lam_max(self, jacobi=False):
        """Per-level lambda_max(M^-1 K) by power iteration (24 normalised
        steps + 1, times 1.05) for the Chebyshev smoother, M the patch
        smoother, or point Jacobi under ``jacobi`` or without patches.
        Start vectors from numpy default_rng(7), one draw per level, as
        in the reference: the Jacobi estimates replay the same draws."""
        rng = np.random.default_rng(7)
        lam_max = []
        for li, lvl in enumerate(self.levels):
            if self.patch_W is not None and not jacobi:
                pc = partial(self._patch_apply, li, lvl.mask, blocked=False)
            else:
                dinv = 1.0 / (lvl.mask * lvl.diag + (1.0 - lvl.mask))
                pc = lambda v, dinv=dinv: dinv * v  # noqa: E731
            x = torch.as_tensor(rng.normal(size=lvl.mask.shape),
                                dtype=self.dtype,
                                device=self.device) * lvl.mask
            for _ in range(24):
                y = pc(self._masked_apply(lvl, lvl.mask, x))
                x = y / torch.linalg.norm(y)
            y = pc(self._masked_apply(lvl, lvl.mask, x))
            lam_max.append(1.05 * float(torch.linalg.norm(y)
                                        / torch.linalg.norm(x)))
        return lam_max

    @property
    def lam_max_jacobi(self):
        """Per-level lambda_max(D^-1 K): the Chebyshev window of the
        levels the distributed V-cycle smooths pointwise
        (parallel/dist_mg.py). Estimated at first use, so a
        single-device setup never pays for it."""
        if self.patch_W is None:
            return self.lam_max
        if self._lam_jacobi is None:
            self._lam_jacobi = self._estimate_lam_max(jacobi=True)
        return self._lam_jacobi

    def _patch_apply(self, li, mask, r, blocked):
        """Masked vertex-star Schwarz apply: mask * sum_p R^T B R (mask*r)."""
        lvl = self.levels[li]
        npg = tuple(reversed(lvl.mesh.npts))
        x = mask * r
        if blocked:
            y = conv.conv_stencil_apply_blocked(x, self.patch_Wb[li], (),
                                                lvl.K.eff_ngl, npg, self.dim)
        else:
            y = conv.conv_stencil_apply(x, self.patch_W[li], (),
                                        lvl.mesh.ngl, npg, self.dim)
        return mask * y

    def _masked_apply(self, lvl: _Level, mask, x, corrections=True):
        if x.dim() > 1 and tuple(x.shape) == lvl.K.blocked_shape_in:
            Kx = lvl.K.apply_blocked(mask * x, corrections=corrections)
        else:
            Kx = lvl.K(mask * x)
        return mask * Kx + (1.0 - mask) * x

    def _subcell_params(self, coarse_mesh, s, ratio):
        """(ncells, step, offset) for fine-grid access of subcell s."""
        N = self.elem.ngl
        digits = []
        ss = s
        for _ in range(self.dim):  # x digit first
            digits.append(ss % ratio)
            ss //= ratio
        ncells = tuple(coarse_mesh.nelem)
        step = ratio * (N - 1)
        offset = tuple((N - 1) * dgt for dgt in digits)
        return ncells, step, offset

    def _prolong(self, lvl: _Level, next_mesh, xc):
        """Natural injection coarse -> fine (grid layout). A padded jump
        scatters onto the extended fine grid and crops to the real one."""
        d = self.dim
        N = self.elem.ngl
        padded = lvl.ext_mesh is not None
        em = lvl.ext_mesh if padded else lvl.mesh
        xce = grid_gather(xc, N, tuple(next_mesh.nelem), N - 1, (0,) * d)
        fine = xc.new_zeros(tuple(reversed(em.npts)) + (d,))
        for s in range(lvl.ratio**d):
            vals = xce @ lvl.interp_k[s].T
            ncells, step, offset = self._subcell_params(next_mesh, s,
                                                        lvl.ratio)
            fine = grid_scatter_add(fine, vals, N, ncells, step, offset)
        fine = fine * lvl.mult_inv
        if padded:
            fine = fine[tuple(slice(0, n) for n in reversed(lvl.mesh.npts))]
        return fine

    def _restrict(self, lvl: _Level, next_mesh, rf):
        """Exact adjoint of _prolong: fine residual -> coarse residual (a
        padded jump zero-pads it to the extended grid first)."""
        d = self.dim
        N = self.elem.ngl
        if lvl.ext_mesh is not None:
            rf = _pad_spatial(rf, [
                (0, en - rn) for en, rn in zip(reversed(lvl.ext_mesh.npts),
                                               reversed(lvl.mesh.npts))])
        rfm = rf * lvl.mult_inv
        rc = rf.new_zeros(tuple(reversed(next_mesh.npts)) + (d,))
        for s in range(lvl.ratio**d):
            ncells, step, offset = self._subcell_params(next_mesh, s,
                                                        lvl.ratio)
            vals = grid_gather(rfm, N, ncells, step, offset)
            rc = grid_scatter_add(rc, vals @ lvl.interp_k[s], N,
                                  tuple(next_mesh.nelem), N - 1, (0,) * d)
        return rc

    # ------------------------------------------------------------------
    # blocked-native transfers: on uniform jumps the subcell transfer is
    # a stride-m block map between the two levels' super-lattices
    # (m = ratio * s_coarse / s_fine blocks)
    # ------------------------------------------------------------------
    def _transfer_kernel(self, li, s_f=None, s_c=None):
        """(Wr, m, e_lo) for the li -> li+1 jump, or None if not
        admissible. s_f / s_c override the levels' own blocked periods
        (a distributed slab's local super factors can differ)."""
        key = (li, s_f, s_c)
        if key in self._tk_cache:
            return self._tk_cache[key]
        lvl, nxt = self.levels[li], self.levels[li + 1]
        sf = s_f if s_f is not None else lvl.K.eff_ngl - 1
        sc = s_c if s_c is not None else nxt.K.eff_ngl - 1
        res = None
        # a padded jump's block map would run over a grid it does not tile
        if lvl.ext_mesh is None and (lvl.ratio * sc) % sf == 0:
            W1, m, e_lo = self._transfer_1d(sf, sc, lvl.ratio)
            Wr = self._tensor_kernel(W1, self.dim, self.dim)
            res = (torch.as_tensor(Wr, dtype=self.dtype, device=self.device),
                   m, e_lo)
        self._tk_cache[key] = res
        return res

    def _transfer_1d(self, s_f, s_c, r):
        """(W1, m, e_lo): the exact dense 1D blocked transfer kernel.

        W1[t][p, q]: fine (block m*bc + t - e_lo, slot p) -> coarse
        (block bc, slot q), read off the dense 1D restriction matrix on a
        small interior probe line.
        """
        N = self.elem.ngl
        P = N - 1
        m = r * s_c // s_f
        e_lo = -(-(r * P) // s_f)
        e_hi = (r * (P - 1)) // s_f
        T = e_lo + m + e_hi + 1
        assert 2 * m - e_lo >= 1 and 3 * m + e_hi < 5 * m
        hs = _subcell_interp_matrices(N, 1, r)      # (r, N, N)
        nel_c1 = 5 * (s_c // P)
        nc1 = nel_c1 * P + 1
        nf1 = r * nel_c1 * P + 1
        R1 = np.zeros((nc1, nf1))
        for e in range(nel_c1):
            for s in range(r):
                R1[e * P:(e + 1) * P + 1,
                   (e * r + s) * P:(e * r + s + 1) * P + 1] += hs[s].T
        W1 = np.zeros((T, s_f, s_c))
        for t in range(T):
            bf = 2 * m + t - e_lo
            W1[t] = R1[2 * s_c:3 * s_c, bf * s_f:(bf + 1) * s_f].T
        return W1, m, e_lo

    @staticmethod
    def _tensor_kernel(W1, d, k):
        """Tensor-product the 1D kernel over d axes, then I_k channels."""
        T, s_f, s_c = W1.shape
        Wk = W1
        for a in range(1, d):
            Wk = np.einsum("...pq,tab->...tpaqb", Wk, W1).reshape(
                (T,) * (a + 1) + (s_f ** (a + 1), s_c ** (a + 1)))
        return np.einsum("...pq,cd->...pcqd", Wk, np.eye(k)).reshape(
            (T,) * d + (s_f**d * k, s_c**d * k))

    def _transfer_subkernels(self, li):
        """(subs, sf, sc, m, e_lo): {d2: Wr_sub} over d2 < dim axes for the
        boundary inclusion-exclusion corrections (_transfer_corr)."""
        if li in self._tks_cache:
            return self._tks_cache[li]
        lvl, nxt = self.levels[li], self.levels[li + 1]
        sf, sc = lvl.K.eff_ngl - 1, nxt.K.eff_ngl - 1
        W1, m, e_lo = self._transfer_1d(sf, sc, lvl.ratio)
        subs = {
            d2: torch.as_tensor(self._tensor_kernel(W1, d2, self.dim),
                                dtype=self.dtype, device=self.device)
            for d2 in range(1, self.dim)
        }
        res = (subs, sf, sc, m, e_lo)
        self._tks_cache[li] = res
        return res

    def _transfer_corr(self, li, xr, Bf, Bc, direction):
        """Boundary corrections making blocked transfers exact on operands
        with nonzero boundary values (e.g. the cavity free-slip mask).

        R_grid = sum_S (-1)^{|S|} (prod_{a in S} E_a)(prod_{a not in S} K_a)
        over axis subsets S: extract the fine boundary plane, transfer it
        with the (d-|S|)-dim kernel and add it at the coarse boundary with
        sign. Returns (index_tuple, value) updates.
        """
        d = k = self.dim
        subs, sf, sc, m, e_lo = self._transfer_subkernels(li)
        restrict = direction == "restrict"
        B_in, B_out = (Bf, Bc) if restrict else (Bc, Bf)
        s_in = sf if restrict else sc
        updates = []
        for j in range(1, d + 1):
            sign = -1.0 if j % 2 else 1.0
            for S in itertools.combinations(range(d), j):
                nonS = [a for a in range(d) if a not in S]
                d2 = d - j
                for sides in itertools.product((0, 1), repeat=j):
                    idx = [slice(None)] * (2 * d + 1)
                    for a, side in zip(S, sides):
                        idx[a] = 0 if side == 0 else B_in[a] - 1
                        idx[d + a] = 0
                    v = xr[tuple(idx)]
                    if d2 > 0:
                        vb = v.reshape(tuple(B_in[a] for a in nonS)
                                       + (s_in**d2 * k,))
                        if restrict:
                            vo = blocked_restrict_apply(
                                vb, subs[d2], m, e_lo,
                                tuple(Bc[a] for a in nonS), d2)
                            vo = vo.reshape(tuple(Bc[a] for a in nonS)
                                            + (sc,) * d2 + (k,))
                        else:
                            vo = blocked_prolong_apply(
                                vb, subs[d2], m, e_lo,
                                tuple(Bf[a] for a in nonS), d2)
                            vo = vo.reshape(tuple(Bf[a] for a in nonS)
                                            + (sf,) * d2 + (k,))
                    else:
                        vo = v
                    oidx = [slice(None)] * (2 * d + 1)
                    for a, side in zip(S, sides):
                        oidx[a] = 0 if side == 0 else B_out[a] - 1
                        oidx[d + a] = 0
                    updates.append((tuple(oidx), sign * vo))
        return updates

    def _level_blocks(self, li):
        lvl, nxt = self.levels[li], self.levels[li + 1]
        s_f = lvl.K.eff_ngl - 1
        s_c = nxt.K.eff_ngl - 1
        Bf = tuple((n - 1) // s_f + 1 for n in reversed(lvl.mesh.npts))
        Bc = tuple((n - 1) // s_c + 1 for n in reversed(nxt.mesh.npts))
        return s_f, s_c, Bf, Bc

    def _blocked_restrict(self, li, xb, corr=False):
        """(Bf..., Cf) fine blocked residual -> (Bc..., Cc) coarse."""
        Wr, m, e_lo = self._transfer_kernel(li)
        s_f, s_c, Bf, Bc = self._level_blocks(li)
        d = k = self.dim
        xw = xb * self.levels[li].mult_b
        out = blocked_restrict_apply(xw, Wr, m, e_lo, Bc, d)
        if corr:
            xr = xw.reshape(Bf + (s_f,) * d + (k,))
            o = out.reshape(Bc + (s_c,) * d + (k,))  # view: in place
            for oidx, val in self._transfer_corr(li, xr, Bf, Bc, "restrict"):
                o[oidx] += val
        return out * self.levels[li + 1].pad_b

    def _blocked_prolong(self, li, xc, corr=False):
        """Adjoint of _blocked_restrict: coarse blocked -> fine blocked."""
        Wr, m, e_lo = self._transfer_kernel(li)
        s_f, s_c, Bf, Bc = self._level_blocks(li)
        d = k = self.dim
        out = blocked_prolong_apply(xc, Wr, m, e_lo, Bf, d).contiguous()
        if corr:
            xr = xc.reshape(Bc + (s_c,) * d + (k,))
            o = out.reshape(Bf + (s_f,) * d + (k,))  # view: in place
            for oidx, val in self._transfer_corr(li, xr, Bf, Bc, "prolong"):
                o[oidx] += val
        lvl = self.levels[li]
        return out * lvl.mult_b * lvl.pad_b

    # ------------------------------------------------------------------
    def build(self, fine_mask=None, frees_boundary: Optional[bool] = None,
              start_level: int = 0) -> Callable:
        """Return M^{-1}(r) closing over the fine-level free-dof mask.

        fine_mask: blocked (the hot path) or grid tensor; the V-cycle runs
        in its layout. frees_boundary: does the mask leave boundary dofs
        free (the phantom corrections are needed then)? Decided here, on
        the host, from the mask when not given. start_level > 0 builds
        the tail V-cycle over levels[start_level:], with that level's own
        Dirichlet mask when fine_mask is None (its blocked mask): the
        agglomerated coarse solve of the distributed V-cycle
        (parallel/dist_mg.py).
        """
        assert self.usable
        levels = self.levels[start_level:]
        nlev = len(levels)
        lam_max = self.lam_max[start_level:]
        if fine_mask is None:
            fine_mask = levels[0].mask_b
        blocked = tuple(fine_mask.shape) == tuple(levels[0].mask_b.shape)
        if frees_boundary is None:
            frees_boundary = conv.mask_frees_boundary(
                fine_mask.detach().cpu().numpy(), levels[0].K.eff_ngl,
                tuple(reversed(levels[0].mesh.npts)))
        # coarse-level masks are fully Dirichlet
        needs_corr = [bool(frees_boundary)] + [False] * (nlev - 1)

        def ldata(li):
            lvl = levels[li]
            if li == 0:
                mask = fine_mask
            else:
                mask = lvl.mask_b if blocked else lvl.mask
            return lvl, mask, (lvl.diag_b if blocked else lvl.diag)

        def smooth(li, x, b, n, x_is_zero=False):
            """Chebyshev(n) smoothing on M^-1 K over [lmax/cheb_div, lmax]."""
            lvl, mask, diag = ldata(li)
            lmax = lam_max[li]
            lmin = lmax / self.cheb_div
            theta = 0.5 * (lmax + lmin)
            delta = 0.5 * (lmax - lmin)
            if self.patch_W is not None:
                pc = partial(self._patch_apply, start_level + li, mask,
                             blocked=blocked)
            else:
                dinv = 1.0 / (mask * diag + (1.0 - mask))
                pc = lambda v: dinv * v  # noqa: E731
            corr = needs_corr[li]
            if x_is_zero:
                x, r = torch.zeros_like(b), b
            else:
                r = b - self._masked_apply(lvl, mask, x, corr)
            d = (1.0 / theta) * pc(r)
            sigma = theta / delta
            rho = 1.0 / sigma
            for _ in range(n):
                x = x + d
                r = r - self._masked_apply(lvl, mask, d, corr)
                rho_new = 1.0 / (2.0 * sigma - rho)
                d = (rho_new * rho) * d + (2.0 * rho_new / delta) * pc(r)
                rho = rho_new
            return x + d

        # blocked-native transfers where the jump admits them; the level-0
        # jump of a boundary-freeing mask adds the exact boundary
        # corrections. Kernels are built here, once.
        tk_use = [False] * max(nlev - 1, 0)
        tk_corr = [False] * max(nlev - 1, 0)
        if blocked:
            for li in range(nlev - 1):
                gli = start_level + li
                if self._transfer_kernel(gli) is None:
                    continue
                tk_use[li] = True
                tk_corr[li] = bool(li == 0 and needs_corr[0])
                if levels[li].mult_b is None:
                    levels[li].mult_b = levels[li].K.to_blocked(
                        levels[li].mult_inv)
                if tk_corr[li]:
                    self._transfer_subkernels(gli)
        # which jumps run blocked-native transfers, and with corrections
        self.last_tk_levels = [(li, tk_corr[li]) for li in range(nlev - 1)
                               if tk_use[li]]

        def restrict(li, res):
            lvl, nxt = levels[li], levels[li + 1]
            if tk_use[li]:
                return self._blocked_restrict(start_level + li, res,
                                              corr=tk_corr[li])
            if blocked:
                res = lvl.K.from_blocked(res)
            rc = self._restrict(lvl, nxt.mesh, res)
            return nxt.K.to_blocked(rc) if blocked else rc

        def prolong(li, xc):
            lvl, nxt = levels[li], levels[li + 1]
            if tk_use[li]:
                return self._blocked_prolong(start_level + li, xc,
                                             corr=tk_corr[li])
            if blocked:
                xc = nxt.K.from_blocked(xc)
            xf = self._prolong(lvl, nxt.mesh, xc)
            return lvl.K.to_blocked(xf) if blocked else xf

        def vcycle(li, r):
            lvl, mask, _ = ldata(li)
            if li == nlev - 1:
                if blocked:
                    rg = lvl.K.from_blocked(r)
                    xg = (self.coarse_inv @ rg.reshape(-1)).reshape(rg.shape)
                    return lvl.K.to_blocked(xg)
                return (self.coarse_inv @ r.reshape(-1)).reshape(r.shape)
            x = smooth(li, None, r, self.pre, x_is_zero=True)
            res = mask * (r - self._masked_apply(lvl, mask, x,
                                                 needs_corr[li]))
            _, mask_c, _ = ldata(li + 1)
            rc = mask_c * restrict(li, res)
            xc = vcycle(li + 1, rc)
            x = x + mask * prolong(li, xc)
            return smooth(li, x, r, self.post)

        def minv(r):
            return fine_mask * vcycle(0, fine_mask * r) + (1.0 - fine_mask) * r

        return minv
