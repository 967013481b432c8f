"""Tensor-product GLL spectral element: basis tables + elemental matrices.

This is the TPU-native re-design of the reference spectral element
(upstream Pynama src/elements/spectral.py). Differences by design:

* Node and quadrature-point ordering is plain lexicographic (x fastest),
  instead of the reference's vertices->edges->interior spectral ordering
  (spectral.py:220-300, 346-431). Orderings only matter internally; parity
  is checked on solution fields at coordinates.
* Elemental matrices are built as vectorized einsums over quadrature points
  and (optionally) batched over elements, instead of per-Gauss-point Python
  accumulation (spectral.py:117-157, 181-215). On uniform box meshes one
  shared elemental matrix serves every element (the reference exploits the
  same fact at base_problem.py:133-137).

Quadrature choices mirror the reference exactly
(spectral.py:39-43): "full" = Gauss(ngl) for ngl<=3 else GLL(ngl);
"reduced" (penalty terms) = Gauss(ngl-1); "op" (nodal projections) =
GLL(ngl) at the nodes themselves. Penalty factors alpha_w=1e2, alpha_d=1e3
(spectral.py:93-94).

The weak forms implemented (KLE = Kinematic Laplacian Equation):
  K   = int grad(v):grad(u) + alpha_d int_red div(v) div(u)
                            + alpha_w int_red curl(v).curl(u)
  Rw  = int v . curl(w)     + alpha_w int_red curl(v) . w
  Rd  = -int v . grad(q)    + alpha_d int_red div(v) q
and the mass-lumped nodal projection operators SrT (strain-rate), DivSrT
(divergence of symmetric tensor), Curl, with lumped weight vector
(spectral.py:159-218).
"""

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from pynama_tpu_torch.elements.lagrange import lagrange_basis
from pynama_tpu_torch.elements.quadrature import gauss_points, lobatto_points

ALPHA_W = 1.0e2  # curl penalty  (reference spectral.py:93)
ALPHA_D = 1.0e3  # div penalty   (reference spectral.py:94)


def _kron_all(mats):
    out = mats[0]
    for m in mats[1:]:
        out = np.kron(out, m)
    return out


@dataclass(frozen=True)
class BasisTables:
    """Basis evaluations at one family of quadrature points.

    H      : (nq, nnode)        nodal basis values
    Hrs    : (nq, dim, nnode)   nodal basis reference-gradient
    Hcoo   : (nq, ncorner)      corner (multilinear geometry) basis values
    Hrscoo : (nq, dim, ncorner) corner basis reference-gradient
    w      : (nq,)              tensor-product quadrature weights
    pts    : (nq, dim)          quadrature point reference coordinates
    """

    H: np.ndarray
    Hrs: np.ndarray
    Hcoo: np.ndarray
    Hrscoo: np.ndarray
    w: np.ndarray
    pts: np.ndarray


def tensor_tables(nodes1d, pts1d, w1d, dim):
    """Build tensor-product basis tables, lexicographic (x fastest).

    Index conventions: local node n = (nz*N + ny)*N + nx, quadrature point
    q = (qz*nq + qy)*nq + qx. Derivative axis 0 is x (reference coord r).
    """
    h, dh = lagrange_basis(nodes1d, pts1d)
    corners1d = np.array([-1.0, 1.0])
    hc, dhc = lagrange_basis(corners1d, pts1d)

    def build(hval, hder):
        # factor order: slowest axis first => [z, y, x]; kron gives x fastest
        H = _kron_all([hval] * dim)
        ders = []
        for axis in range(dim):  # axis 0 = x
            factors = [hval] * dim
            factors[dim - 1 - axis] = hder
            ders.append(_kron_all(factors))
        return H, np.stack(ders, axis=1)

    H, Hrs = build(h, dh)
    Hcoo, Hrscoo = build(hc, dhc)
    w = _kron_all([np.asarray(w1d)] * dim)

    nq1 = len(pts1d)
    grids = np.meshgrid(*([np.asarray(pts1d)] * dim), indexing="ij")
    # grids[0] varies slowest => it is the last coordinate axis (z or y)
    pts = np.stack([g.reshape(-1) for g in reversed(grids)], axis=1)
    assert H.shape == (nq1**dim, len(nodes1d) ** dim)
    return BasisTables(H=H, Hrs=Hrs, Hcoo=Hcoo, Hrscoo=Hrscoo, w=w, pts=pts)


def geometry(tables: BasisTables, corners):
    """Jacobian geometry at quadrature points for a batch of elements.

    corners: (E, ncorner, dim) element corner coordinates (lexicographic
    corner order, x fastest). Returns (Hxy, wdetJ) with
    Hxy (E, nq, dim, nnode) physical gradients and wdetJ (E, nq).
    """
    corners = np.asarray(corners, dtype=np.float64)
    if corners.ndim == 2:
        corners = corners[None]
    # J[e,q,a,b] = d x_b / d xi_a
    J = np.einsum("qac,ecb->eqab", tables.Hrscoo, corners)
    detJ = np.linalg.det(J)
    Jinv = np.linalg.inv(J)
    # Hxy[e,q,a,n] = d phi_n / d x_a = (J^-1)_{a b} dphi_n/dxi_b ... careful:
    # dphi/dx_a = sum_b (dxi_b/dx_a) dphi/dxi_b = (J^{-T})_{ab}? Use solve:
    # grad_x = J^{-1} applied as inv(J) . grad_xi with J as defined above:
    # dphi/dxi_a = sum_b (dx_b/dxi_a) dphi/dx_b = J[a,b] gradx[b]
    # => gradx = J^{-1} grad_xi  (solving J gradx = grad_xi)
    Hxy = np.einsum("eqab,qbn->eqan", Jinv, tables.Hrs)
    return Hxy, detJ * tables.w[None, :]


class SpectralElement:
    """GLL spectral element of order ngl-1 in dim (2 or 3) dimensions.

    Parity: upstream Pynama src/elements/spectral.py:9-37 (Spectral).
    """

    def __init__(self, ngl: int, dim: int):
        if dim not in (2, 3):
            raise ValueError("dim must be 2 or 3")
        self.ngl = ngl
        self.dim = dim
        self.dim_w = 1 if dim == 2 else 3
        self.dim_s = 3 if dim == 2 else 6
        self.nnode = ngl**dim
        self.ncorner = 2**dim

        nodes1d, nodal_w1d = lobatto_points(ngl)
        self.nodes1d = nodes1d
        self.nodal_weights1d = nodal_w1d

        if ngl <= 3:
            full_pts, full_w = gauss_points(ngl)
        else:
            full_pts, full_w = lobatto_points(ngl)
        red_pts, red_w = gauss_points(ngl - 1)

        self.full = tensor_tables(nodes1d, full_pts, full_w, dim)
        self.red = tensor_tables(nodes1d, red_pts, red_w, dim)
        self.op = tensor_tables(nodes1d, nodes1d, nodal_w1d, dim)

    # ------------------------------------------------------------------
    # gradient-operator layouts at quadrature points
    # ------------------------------------------------------------------
    def _vel_div_rows(self, Hxy):
        """B_div (E, nq, nnode*dim): div u with interleaved vel dofs."""
        E, nq, dim, n = Hxy.shape
        # col m*dim + j gets Hxy[j, m]
        return np.transpose(Hxy, (0, 1, 3, 2)).reshape(E, nq, n * dim)

    def _vel_curl_rows(self, Hxy):
        """B_curl (E, nq, dim_w, nnode*dim): curl of the velocity field."""
        E, nq, dim, n = Hxy.shape
        B = np.zeros((E, nq, self.dim_w, n * dim))
        if dim == 2:
            B[:, :, 0, 1::2] = Hxy[:, :, 0, :]   # +dv/dx
            B[:, :, 0, 0::2] = -Hxy[:, :, 1, :]  # -du/dy
        else:
            B[:, :, 0, 2::3] = Hxy[:, :, 1, :]   # +dw/dy
            B[:, :, 0, 1::3] = -Hxy[:, :, 2, :]  # -dv/dz
            B[:, :, 1, 0::3] = Hxy[:, :, 2, :]   # +du/dz
            B[:, :, 1, 2::3] = -Hxy[:, :, 0, :]  # -dw/dx
            B[:, :, 2, 1::3] = Hxy[:, :, 0, :]   # +dv/dx
            B[:, :, 2, 0::3] = -Hxy[:, :, 1, :]  # -du/dy
        return B

    def _vort_curl_rows(self, Hxy):
        """W (E, nq, dim, nnode*dim_w): curl of the vorticity field.

        2D: curl of scalar w = (dw/dy, -dw/dx); 3D: standard vector curl.
        Parity: indWCurl tables, reference spectral.py:26-31.
        """
        E, nq, dim, n = Hxy.shape
        if dim == 2:
            W = np.zeros((E, nq, 2, n))
            W[:, :, 0, :] = Hxy[:, :, 1, :]      # +dw/dy
            W[:, :, 1, :] = -Hxy[:, :, 0, :]     # -dw/dx
            return W
        return self._vel_curl_rows(Hxy)

    def _srt_rows(self, Hxy):
        """B_srt (E, nq, dim_s, nnode*dim): trace-shifted strain components.

        Reproduces the reference's component definition exactly
        (spectral.py:189-207): in 2D
          s0=(u_x - v_y)/2, s1=(u_y + v_x)/2, s2=(v_y - u_x)/2
        in 3D
          s0=(u_x - v_y - w_z)/2, s1=(u_y + v_x)/2, s2=(v_y - u_x - w_z)/2,
          s3=(v_z + w_y)/2,      s4=(w_z - u_x - v_y)/2, s5=(u_z + w_x)/2.
        (Equals the deviatoric strain when div u = 0.)
        """
        E, nq, dim, n = Hxy.shape
        B = np.zeros((E, nq, self.dim_s, n * dim))
        gx = Hxy[:, :, 0, :]
        gy = Hxy[:, :, 1, :]
        if dim == 2:
            B[:, :, 0, 0::2] = gx
            B[:, :, 0, 1::2] = -gy
            B[:, :, 1, 0::2] = gy
            B[:, :, 1, 1::2] = gx
            B[:, :, 2, 0::2] = -gx
            B[:, :, 2, 1::2] = gy
        else:
            gz = Hxy[:, :, 2, :]
            B[:, :, 0, 0::3] = gx
            B[:, :, 0, 1::3] = -gy
            B[:, :, 0, 2::3] = -gz
            B[:, :, 1, 0::3] = gy
            B[:, :, 1, 1::3] = gx
            B[:, :, 2, 0::3] = -gx
            B[:, :, 2, 1::3] = gy
            B[:, :, 2, 2::3] = -gz
            B[:, :, 3, 1::3] = gz
            B[:, :, 3, 2::3] = gy
            B[:, :, 4, 0::3] = -gx
            B[:, :, 4, 1::3] = -gy
            B[:, :, 4, 2::3] = gz
            B[:, :, 5, 0::3] = gz
            B[:, :, 5, 2::3] = gx
        return 0.5 * B

    def _div_srt_rows(self, Hxy):
        """B_divs (E, nq, dim, nnode*dim_s): divergence of a sym tensor.

        2D: r0 = dx s0 + dy s1 ; r1 = dx s1 + dy s2.
        3D: r0 = dx s0 + dy s1 + dz s5 ; r1 = dx s1 + dy s2 + dz s3 ;
            r2 = dx s5 + dy s3 + dz s4.  (indBdiv, reference spectral.py:28,33)
        """
        E, nq, dim, n = Hxy.shape
        ds = self.dim_s
        B = np.zeros((E, nq, dim, n * ds))
        if dim == 2:
            comp = [[0, 1], [1, 2]]
        else:
            comp = [[0, 1, 5], [1, 2, 3], [5, 3, 4]]
        for i in range(dim):       # output vector component
            for a in range(dim):   # derivative axis
                B[:, :, i, comp[a][i]::ds] = Hxy[:, :, a, :]
        return B

    # ------------------------------------------------------------------
    # elemental matrices
    # ------------------------------------------------------------------
    def kle_matrices(self, corners):
        """Elemental K, Rw, Rd for a batch of elements.

        corners: (E, 2**dim, dim) or (2**dim, dim). Returns arrays of shape
        (E, nnode*dim, nnode*dim), (E, nnode*dim, nnode*dim_w),
        (E, nnode*dim, nnode), squeezed if input was unbatched.
        Parity: reference spectral.py:89-157 (getElemKLEMatrices).
        """
        single = np.asarray(corners).ndim == 2
        n, d, dw = self.nnode, self.dim, self.dim_w

        Hxy, wdet = geometry(self.full, corners)
        HxyR, wdetR = geometry(self.red, corners)
        E = Hxy.shape[0]

        # K: vector Laplacian = kron(scalar stiffness, I_dim)
        Ks = np.einsum("eqan,eqam,eq->enm", Hxy, Hxy, wdet)
        K = np.einsum("enm,ij->enimj", Ks, np.eye(d)).reshape(E, n * d, n * d)

        # penalties at reduced quadrature
        Dv = self._vel_div_rows(HxyR)                       # (E,nq,nd)
        K += ALPHA_D * np.einsum("eqa,eqb,eq->eab", Dv, Dv, wdetR)
        Cv = self._vel_curl_rows(HxyR)                      # (E,nq,dw,nd)
        K += ALPHA_W * np.einsum("eqia,eqib,eq->eab", Cv, Cv, wdetR)

        # Rw = int v . curl(w) + alpha_w int_red curl(v) . w
        Wc = self._vort_curl_rows(Hxy)                      # (E,nq,d,n*dw)
        Rw = np.einsum("qn,eqia,eq->enia", self.full.H, Wc, wdet)
        Rw = Rw.reshape(E, n * d, n * dw)
        RwR = ALPHA_W * np.einsum("eqca,qm,eq->eamc", Cv, self.red.H, wdetR)
        Rw += RwR.reshape(E, n * d, n * dw)

        # Rd = -int v . grad(q) + alpha_d int_red div(v) q
        Rd = -np.einsum("qn,eqim,eq->enim", self.full.H, Hxy, wdet)
        Rd = Rd.reshape(E, n * d, n)
        Rd += ALPHA_D * np.einsum("eqa,qm,eq->eam", Dv, self.red.H, wdetR)

        if single:
            return K[0], Rw[0], Rd[0]
        return K, Rw, Rd

    def kle_operators(self, corners):
        """Elemental SrT, DivSrT, Curl and lumped weight vector.

        Nodal (GLL-point) quadrature so the assembled, weight-scaled global
        operators are nodal projections.
        Parity: reference spectral.py:159-218 (getElemKLEOperators).
        """
        single = np.asarray(corners).ndim == 2
        n, d, dw, ds = self.nnode, self.dim, self.dim_w, self.dim_s

        Hxy, wdet = geometry(self.op, corners)
        H = self.op.H
        E = Hxy.shape[0]

        Bs = self._srt_rows(Hxy)                            # (E,nq,ds,n*d)
        SrT = np.einsum("qm,eqsa,eq->emsa", H, Bs, wdet).reshape(E, n * ds, n * d)

        Bd = self._div_srt_rows(Hxy)                        # (E,nq,d,n*ds)
        DivSrT = np.einsum("qm,eqia,eq->emia", H, Bd, wdet).reshape(E, n * d, n * ds)

        Bc = self._vel_curl_rows(Hxy)                       # (E,nq,dw,n*d)
        Curl = np.einsum("qm,eqca,eq->emca", H, Bc, wdet).reshape(E, n * dw, n * d)

        # lumped weights: row sums of the mass matrix int H^T H
        wvec = np.einsum("qn,q,eq->en", H, H.sum(axis=1), wdet)

        if single:
            return SrT[0], DivSrT[0], Curl[0], wvec[0]
        return SrT, DivSrT, Curl, wvec

    @cached_property
    def nodal_points(self):
        """Reference coordinates of the element's GLL nodes, (nnode, dim)."""
        return self.op.pts
