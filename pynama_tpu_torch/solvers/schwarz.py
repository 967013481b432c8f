"""Additive-Schwarz preconditioning for unstructured (Gmsh) meshes.

Port of pynama_tpu/solvers/schwarz.py. Structured box meshes get
geometric multigrid (solvers/multigrid.py); gather/scatter meshes get
patch-block additive Schwarz

    M^-1 = sum_p R_p^T (K_p)^-1 R_p      (free dofs)
           + R_c^T A_c^-1 R_c            (Q1 coarse level, small meshes)
           + identity on constrained dofs,

with K_p the principal submatrix of the ASSEMBLED masked KLE stiffness
on patch p's dofs (every principal submatrix of an SPD matrix is SPD,
where a raw interior element block is singular). Patches are vertex
stars (all dofs of the cells sharing a corner vertex) or, when their
blocks would outgrow ``_MAX_BLOCK_ENTRIES``, single elements.

The setup is host numpy and scipy, as in the reference: the assembled,
masked K in CSR, the padded patch blocks (the sentinel dof n carries an
identity row), ``np.linalg.inv``, the coarse matrix R^T K R inverted
densely. The blocks and the transfer tables move to the device once
built. The apply is an ElementOp (ops/assembly.py) on the residual
extended by the sentinel's zero, plus the coarse correction, then the
mask; both scatters are the deterministic contributor-table sums.

The patch tables and the block entries are built vectorised: the same
patches, in the same order, and the same block values as the
reference's per-patch loop.
"""

import logging

import numpy as np
import torch

from pynama_tpu_torch.device import resolve_device
from pynama_tpu_torch.ops.assembly import (contributor_table,
                                           make_element_op, scatter_add)

logger = logging.getLogger("pynama_tpu_torch")

# block-inverse storage guard: (P, L, L) entries beyond this many
# (~1.6 GB in float64) make vertex stars retry as element blocks, and
# element blocks fall back to Jacobi
_MAX_BLOCK_ENTRIES = 2 * 10**8

# dense coarse inverses beyond this dof count cost more than they save
_MAX_COARSE_DOFS = 6000

# block entries built and inverted per host thread at a time (bounds host
# memory)
_CHUNK_ENTRIES = 2 * 10**6


class SchwarzPreconditioner:
    """r -> M^-1 r for the masked KLE system (flat vectors), the layout
    of KLESystem.apply_masked: the identity on constrained dofs.

    ``patches`` is "vertex" or "element", ``n_patches`` and
    ``block_dofs`` the shape of the block table, ``coarse_dofs`` the
    coarse level's size (0: one-level).
    """

    def __init__(self, op, mask, coarse, patches, coarse_dofs):
        self.op = op
        self.mask = mask
        self.coarse = coarse
        self.patches = patches
        self.n_patches, self.block_dofs = tuple(op.in_dofs.shape)
        self.coarse_dofs = coarse_dofs

    def __call__(self, r):
        shape = r.shape
        rf = r.reshape(-1)
        y = self.op(torch.cat([rf, rf.new_zeros(1)]))
        if self.coarse is not None:
            y = y + self.coarse(rf)
        m = self.mask
        return (m * y + (1.0 - m) * rf).reshape(shape)


def assembled_masked_K(mesh, K_el, free_mask):
    """The assembled K of (E, nk, nk) or (nk, nk) elemental blocks with the
    mask applied as D K D + (I - D), in canonical CSR (sorted, summed)."""
    import scipy.sparse as sp

    dim = mesh.dim
    dofs = np.asarray(mesh.cell_dofs(dim), dtype=np.int64)
    E, nk = dofs.shape
    n = mesh.n_nodes * dim
    Ke = np.asarray(K_el, dtype=np.float64)
    if Ke.ndim == 2:
        Ke = np.broadcast_to(Ke, (E,) + Ke.shape)
    m = np.asarray(free_mask, dtype=np.float64).reshape(-1)
    rows = np.repeat(dofs, nk, axis=1).reshape(-1)
    cols = np.tile(dofs, (1, nk)).reshape(-1)
    K = sp.coo_matrix((Ke.reshape(-1), (rows, cols)), shape=(n, n)).tocsr()
    D = sp.diags(m)
    K = (D @ K @ D + sp.diags(1.0 - m)).tocsr()
    K.sum_duplicates()
    return K, dofs, m


def patch_blocks(K, keys, ptab, n):
    """(P, L, L) principal submatrices of the CSR ``K`` (canonical: sorted
    and summed; ``keys`` = row * n + column of its entries, increasing) on
    the rows of ``ptab`` (P, L); slots holding the sentinel n get an
    identity row and column."""
    idx = np.minimum(ptab, n - 1)
    q = idx[:, :, None] * n + idx[:, None, :]
    pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    A = np.where(keys[pos] == q, K.data[pos], 0.0)
    pad = ptab == n
    A[pad[:, :, None] | pad[:, None, :]] = 0.0
    pp, ll = np.nonzero(pad)
    A[pp, ll, ll] = 1.0
    return A


def inverse_blocks(K, ptab, n):
    """np.linalg.inv of the patch blocks of ``K``, over chunks of patches
    by torch's number of host threads (numpy releases the GIL in both;
    each block's inverse is the same bits whatever the chunk)."""
    from concurrent.futures import ThreadPoolExecutor

    keys = np.repeat(np.arange(n, dtype=np.int64), np.diff(K.indptr)) * n \
        + K.indices.astype(np.int64)
    P, L = ptab.shape
    step = max(1, _CHUNK_ENTRIES // (L * L))
    chunks = [ptab[i:i + step] for i in range(0, P, step)]
    with ThreadPoolExecutor(max(1, min(len(chunks),
                                       torch.get_num_threads()))) as pool:
        return np.concatenate(list(pool.map(
            lambda t: np.linalg.inv(patch_blocks(K, keys, t, n)), chunks)))


def build_element_schwarz(mesh, K_el, free_mask, dtype=torch.float64,
                          patches="vertex", device=None):
    """A SchwarzPreconditioner for the masked KLE system, or None (blocks
    too big even as elements: Jacobi-CG then).

    K_el: (nk, nk) shared or (E, nk, nk) per-element stiffness (numpy);
    free_mask: flat (n_nodes*dim,) 1/0 free-dof mask (numpy). patches:
    "vertex" (default: vertex stars, generous overlap) or "element"
    (smaller, weaker); vertex stars over the guard retry as elements.
    """
    device = resolve_device(device)
    K, dofs, m = assembled_masked_K(mesh, K_el, free_mask)
    n = K.shape[0]
    while True:
        ptab = _vertex_star_dofs(mesh, dofs, n) if patches == "vertex" \
            else dofs
        P, L = ptab.shape
        if P * L * L <= _MAX_BLOCK_ENTRIES:
            break
        if patches != "vertex":
            logger.warning("Schwarz blocks would need %d entries (> %d); "
                           "falling back to Jacobi", P * L * L,
                           _MAX_BLOCK_ENTRIES)
            return None
        patches = "element"

    B = inverse_blocks(K, ptab, n)
    # output size n: the sentinel's row n is dropped by the scatter
    op = make_element_op(B, ptab, ptab, n, dtype, device)
    mask = torch.as_tensor(m, dtype=dtype, device=device)
    coarse, coarse_dofs = _coarse_level(mesh, K, mesh.dim, dtype, device)
    return SchwarzPreconditioner(op, mask, coarse, patches, coarse_dofs)


def _vertex_star_dofs(mesh, cell_dofs, n):
    """(n_vertices, L) dof table of vertex-star patches: patch v = the
    sorted dofs of every cell with corner vertex v, vertices in
    increasing order, rows padded to the largest star with the sentinel
    dof n."""
    corners = np.asarray(mesh._corners_lex, dtype=np.int64)
    E, nc = corners.shape
    nk = cell_dofs.shape[1]
    v = np.broadcast_to(corners[:, :, None], (E, nc, nk)).reshape(-1)
    d = np.broadcast_to(cell_dofs[:, None, :], (E, nc, nk)).reshape(-1)
    keys = np.unique(v * (n + 1) + d)
    verts, dof = keys // (n + 1), keys % (n + 1)
    _, start, count = np.unique(verts, return_index=True, return_counts=True)
    out = np.full((len(count), int(count.max())), n, dtype=np.int64)
    out[np.repeat(np.arange(len(count)), count),
        np.arange(len(keys)) - np.repeat(start, count)] = dof
    return out


def _coarse_level(mesh, K, dim, dtype, device):
    """(r -> R A_c^-1 R^T r, coarse dofs), or (None, 0) when the coarse
    system exceeds the dense-inverse budget: the additive Q1 corner-vertex
    correction, R the bilinear/trilinear corner -> GLL interpolation
    (mesh.corner_interp) per velocity component, A_c = R^T K R with the
    masked assembled K, inverted in float64 at setup."""
    import scipy.sparse as sp

    cols, wts = mesh.corner_interp
    nv = int(cols.max()) + 1
    if nv * dim > _MAX_COARSE_DOFS:
        logger.warning("Schwarz coarse space %d dofs > %d: running "
                       "one-level", nv * dim, _MAX_COARSE_DOFS)
        return None, 0
    n_nodes, mw = cols.shape
    ccols = cols[:, :, None] * dim + np.arange(dim)[None, None, :]
    rows = (np.arange(n_nodes)[:, None, None] * dim
            + np.arange(dim)[None, None, :]
            + np.zeros((1, mw, 1), dtype=np.int64))
    vals = np.broadcast_to(wts[:, :, None], (n_nodes, mw, dim))
    R = sp.coo_matrix(
        (vals.reshape(-1), (rows.reshape(-1), ccols.reshape(-1))),
        shape=(n_nodes * dim, nv * dim)).tocsr()
    Ac = (R.T @ K @ R).toarray()
    Ac_inv = torch.as_tensor(np.linalg.inv(Ac), dtype=dtype, device=device)
    # the unused slots (weight 0, on corner 0) stay out of the table:
    # kept, they would make corner 0's row as long as the mesh
    table = torch.as_tensor(contributor_table(np.where(wts != 0, cols, -1),
                                              nv), device=device)
    colsd = torch.as_tensor(cols, device=device)
    wtsd = torch.as_tensor(wts, dtype=dtype, device=device)

    def coarse(rf):
        rn = rf.reshape(n_nodes, dim)
        contrib = wtsd[:, :, None] * rn[:, None, :]        # (n, mw, dim)
        rc = scatter_add(contrib.reshape(n_nodes * mw, dim), table)
        xc = (Ac_inv @ rc.reshape(-1)).reshape(nv, dim)
        return (wtsd[:, :, None] * xc[colsd]).sum(dim=1).reshape(-1)

    return coarse, nv * dim
