"""Distributed geometric multigrid for the slab-decomposed NS solver.

Port of pynama_tpu/parallel/dist_mg.py: the single-device V-cycle of
solvers/multigrid.py, run by every rank on its slab, so the distributed
KLE solves keep mesh-independent iteration counts:

  * every distributed level's grid is slab-partitioned identically (the
    rank count divides each such level's last-axis element count);
  * smoothing = Chebyshev over local masked applies + one-plane halo;
    where each rank owns at least Q+1 blocks, the vertex-star patch
    smoother decomposed linearly over the slabs (dist_patch_apply),
    elsewhere point Jacobi with its own Chebyshev window;
  * transfers: the blocked stride-m kernels with ghost margins
    (_margin_sum), or the subcell gather/GEMM/scatter on the local grid
    plus the halo, then the global node-multiplicity weights;
  * the coarsest level: all-gather the residual, drop the duplicated
    interface planes, and run the dense masked inverse, or the
    single-device tail V-cycle over the levels the slab cannot divide
    (coarse-grid agglomeration), on every rank; each keeps its rows.

Every local apply goes through StructuredElementOp.apply_blocked, hence
the stencil kernels. A rank holds only its own tensors: the reference's
device-stacked pytree is, per level, a dict of this rank's tensors here
(``convert.stacked_to_rank`` carries the reference's across).
"""

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as tnf

from pynama_tpu_torch.ops import conv, stencil
from pynama_tpu_torch.ops.structured import (StructuredElementOp,
                                             grid_gather, grid_scatter_add,
                                             pick_super_factor)
from pynama_tpu_torch.parallel.slab import (GridDecomposition, RankGrid,
                                            exchange, halo_sum_blocked_axis)
from pynama_tpu_torch.solvers.multigrid import (blocked_prolong_apply,
                                                blocked_restrict_apply)


@dataclass
class _DistMGMeta:
    """Static (non-tensor) description of the distributed hierarchy."""

    ngl: int
    dim: int
    lam_max: List[float]
    ratios: List[int]
    local_nelem: List[tuple]   # per level, MESH order
    local_npts: List[tuple]    # per level, MESH order
    rows_loc: List[int]        # node planes per rank per level
    pre: int = 3
    post: int = 3
    # vertex-star patch smoothing (levels where it is active); lam_max
    # then holds the PATCH-preconditioned spectrum bound for that level
    use_patch: List[bool] = field(default_factory=list)
    cheb_div: List[float] = field(default_factory=list)
    # per-level super-blocking of the LOCAL blocked layout (picked on the
    # local nelem); effs[li] = sbs[li]*(ngl-1)+1
    sbs: List[int] = field(default_factory=list)
    effs: List[int] = field(default_factory=list)
    # blocked-native transfer (m, e_lo) per jump (None = grid-path
    # transfer); kernels live in repl["levels"][li]["Wt"]
    tms: List[Optional[tuple]] = field(default_factory=list)
    # coarse-grid agglomeration: the distributed hierarchy covers only
    # the leading slab-divisible levels; the coarser tail runs as the
    # single-device V-cycle on every rank after an all-gather
    aggl: bool = False
    tail_npts: Optional[tuple] = None  # agglomeration level, MESH order
    tail_ngl: Optional[int] = None     # its blocked-layout period + 1


def build_dist_mg(mg, sharded):
    """Distribute a built MGPreconditioner over a ShardedNSProblem's slab.

    Returns (meta, local, repl): ``local`` a list of per-level dicts of
    this rank's tensors (diag, mask, half, mult, mult_b), ``repl`` what
    every rank holds alike; or None when the hierarchy cannot be
    slab-partitioned (pencils, or a rank count that does not divide the
    fine level's last axis).
    """
    if sharded.naxes != 1:
        return None
    n_dev = sharded.n_dev
    coords = sharded.ranks.coords
    dim = mg.dim
    N = mg.elem.ngl
    dtype, device = sharded.p.dtype, sharded.p.device

    # distributed prefix: levels whose last mesh axis the slab divides,
    # cut at the first padded (fictitious-domain) jump — the transfer
    # across it stays single-device. Everything coarser runs agglomerated.
    nlev_full = len(mg.levels)
    m = 0
    for li, lvl in enumerate(mg.levels):
        if lvl.mesh.nelem[-1] % n_dev != 0:
            break
        m = li + 1
        if li < nlev_full - 1 and lvl.ext_mesh is not None:
            break  # padded jump: level li is the last distributed one
    if m == 0:
        return None
    aggl = m < nlev_full

    # per-level smoother: the patch smoother where every rank owns at
    # least Q+1 local blocks (the footprint-Q margin exchange reaches one
    # neighbour each side; Q=1 super-blocked, Q=2 parity), pointwise
    # Jacobi elsewhere, each with its own Chebyshev window
    use_patch, lam, cdiv, sbs, effs = [], [], [], [], []
    for li, lvl in enumerate(mg.levels[:m]):
        dec_li = GridDecomposition(lvl.mesh, (n_dev,))
        f_li = pick_super_factor(tuple(dec_li.local_nelem), N, dim)
        sbs.append(f_li)
        effs.append(f_li * (N - 1) + 1)
        ne_loc_last = lvl.mesh.nelem[-1] // n_dev
        ok = (mg.patch_W is not None
              and (ne_loc_last // f_li) + 1 >= (2 if f_li > 1 else 3))
        use_patch.append(ok)
        lam.append(mg.lam_max[li] if ok else mg.lam_max_jacobi[li])
        cdiv.append(mg.cheb_div if ok else 4.0)

    meta = _DistMGMeta(
        ngl=N, dim=dim, lam_max=lam,
        ratios=[lv.ratio for lv in mg.levels[:m - 1]],
        local_nelem=[], local_npts=[], rows_loc=[],
        pre=mg.pre, post=mg.post,
        use_patch=use_patch, cheb_div=cdiv, sbs=sbs, effs=effs,
        aggl=aggl,
        tail_npts=tuple(mg.levels[m - 1].mesh.npts) if aggl else None,
        tail_ngl=mg.levels[m - 1].K.eff_ngl if aggl else None,
    )

    def tens(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    local, repl = [], []
    for li, lvl in enumerate(mg.levels[:m]):
        dec = GridDecomposition(lvl.mesh, (n_dev,))
        meta.local_nelem.append(dec.local_nelem)
        meta.local_npts.append(dec.local_npts)
        meta.rows_loc.append(dec.rows_loc[0])
        eff = effs[li]

        def loc_grid(g):
            flat = g.detach().cpu().numpy().reshape(-1)
            return dec.to_local_grid(flat, dim)[coords]

        def blocked(g):
            return tens(conv.to_blocked_np(g, eff))

        # input-ownership weights for the linear decomposition of
        # kernel-form operators (patch smoother, blocked transfers):
        # interior slab-interface node planes carry 0.5 on BOTH owners,
        # so sum_d x_owned_d == x_global exactly
        half = np.ones((n_dev,) + tuple(reversed(dec.local_npts)) + (dim,))
        if n_dev > 1:
            half[:-1, -1] = 0.5  # upper interface plane (grid axis 0)
            half[1:, 0] = 0.5    # lower interface plane
        st = {"diag": blocked(loc_grid(lvl.diag)),
              "mask": blocked(loc_grid(lvl.mask)),
              "half": blocked(half[coords])}
        rp = {"A": lvl.K.A.to(dtype)}
        if use_patch[li]:
            rp["patch_W"] = tens(conv.rebase_conv_kernel(
                mg.patch_W[li].detach().cpu().numpy(), sbs[li], dim, dim,
                dim, N))
        if li + 1 < m:
            mult = loc_grid(lvl.mult_inv)
            st["mult"] = tens(mult)  # grid layout
            st["mult_b"] = blocked(mult)
            rp["interp"] = lvl.interp_k
            # blocked-native transfer kernel at the LOCAL periods; the
            # margin machinery covers one ghost block per side, so only
            # kernels whose tap window stays within that (upward restrict
            # reach e_lo // m == 0) qualify
            tk = mg._transfer_kernel(li, effs[li] - 1, effs[li + 1] - 1)
            if tk is not None and tk[2] // tk[1] == 0:
                rp["Wt"] = tk[0]
                meta.tms.append((tk[1], tk[2]))
            else:
                meta.tms.append(None)
        local.append(st)
        repl.append(rp)
    repl_top = {"levels": repl}
    if aggl:
        # the single-device tail V-cycle over levels [m-1:], the same
        # arithmetic as the single-device preconditioner from there down
        repl_top["tail"] = mg.build(start_level=m - 1)
    else:
        repl_top["coarse_inv"] = mg.coarse_inv
    return meta, local, repl_top


def masked_corrections(op, mask, ranks: RankGrid):
    """The phantom-cell corrections of a local op (blocked layout) that a
    masked operand ``mask * x`` can make nonzero on this rank.

    A correction reads the operand on its pinned boundary planes only,
    so its term is exactly zero when one of them is a domain-boundary
    plane that the mask pins whole; slab-interface planes hold partial
    sums and keep theirs. On one rank with a Dirichlet mask none is left,
    as the single-device path's ``corrections=False``
    (conv.mask_frees_boundary). Decided once, on the host.
    """
    _, corr = op._kernels()
    dim = len(op.nelem)
    P = op.eff_ngl - 1
    m = mask.detach().cpu().numpy()
    B = m.shape[:dim]
    mr = m.reshape(B + (P,) * dim + (m.shape[-1] // P**dim,))

    def zero_plane(ax, side):
        if ax < len(ranks.pgrid) and (
                ranks.coords[ax] > 0 if side == 0
                else ranks.coords[ax] < ranks.pgrid[ax] - 1):
            return False  # a slab interface
        idx = [slice(None)] * mr.ndim
        idx[ax] = 0 if side == 0 else B[ax] - 1
        idx[dim + ax] = 0
        return not np.any(mr[tuple(idx)] != 0.0)

    return tuple(c for c in corr
                 if not any(zero_plane(ax, side) for ax, side in c[0]))


def dist_patch_apply(W, half, mask, r, ranks: RankGrid):
    """Distributed masked vertex-star Schwarz: sum_p R_p^T B R_p.

    The single-device footprint-5 blocked conv decomposed linearly over
    slabs: each rank owns a share of the input (interface node planes
    carry weight 0.5 on BOTH owners, so the shares sum to the global
    vector), convolves it over its slab EXTENDED by the Q-block write
    radius, and the ghost margins are exchanged and summed —
    sum_d conv(x_d) == conv(x) exactly. Mirrors
    MGPreconditioner._patch_apply (solvers/multigrid.py).
    """
    Q = (W.shape[0] - 1) // 2  # 2 for the vertex-star footprint 5
    xo = mask * r * half
    B0 = xo.shape[0]
    pad = (0, 0) * (xo.dim() - 1) + (Q, Q)
    y_ext = stencil.conv_blocked(tnf.pad(xo, pad), W)
    y = y_ext[Q:B0 + Q]
    if ranks.pgrid[0] > 1:
        # margin exchange: [ghost-Q.., block0] down, [last block,
        # ..ghost+Q] up; my block 0 == the lower neighbour's LAST block
        # (the same global element block)
        m = Q + 1
        from_above, from_below = exchange(y_ext[:m], y_ext[B0 + Q - 1:],
                                          ranks, 0)
        if from_above is not None:
            y[B0 - m:] += from_above
        if from_below is not None:
            y[:m] += from_below
    # mask re-zeroes pad slots (the received neighbour margins carry the
    # neighbour's real values in slots that are pad on this rank)
    return mask * y


def _margin_sum(y_ext, gl, gh, B0, ranks: RankGrid):
    """Exchange block margins of a kernel-form operator output.

    y_ext covers local blocks [-gl, B0 + gh) along the partitioned axis
    (axis 0); my block 0 == the lower neighbour's block B0-1 (the same
    global block). Sending my blocks [-gl..0] down and [B0-1..B0-1+gh]
    up and adding the received margins completes
    sum_d conv(zero-extended owned share) == conv(x_global) on every
    stored block of every rank.
    """
    core = y_ext[gl:gl + B0]
    if ranks.pgrid[0] == 1:
        return core
    from_above, from_below = exchange(y_ext[:gl + 1], y_ext[gl + B0 - 1:],
                                      ranks, 0)
    if from_above is not None:
        core[B0 - 1 - gl:] += from_above
    if from_below is not None:
        core[:gh + 1] += from_below
    return core


def make_minv(meta: _DistMGMeta, local, repl, fine_mask, ranks: RankGrid,
              fine_boundary_free=True):
    """The distributed V-cycle closure M^-1(r) of this rank.

    local: build_dist_mg's per-level dicts of this rank's tensors; repl:
    the shared part; fine_mask: the caller's fine-level free mask (local
    blocked layout). fine_boundary_free: does the GLOBAL solve mask free
    any domain-boundary dof? If so, level 0 keeps the grid-path transfer
    (the kernels' phantom windows read boundary planes — exact only on
    zero-boundary operands; see MGPreconditioner.build).
    """
    N, dim = meta.ngl, meta.dim
    nlev = len(local)
    effs = meta.effs

    ops = [
        StructuredElementOp(repl["levels"][li]["A"], N,
                            meta.local_nelem[li], meta.local_npts[li], dim,
                            dim, sb=meta.sbs[li])
        for li in range(nlev)
    ]

    def halo(li, y):
        return halo_sum_blocked_axis(y, effs[li] - 1, dim, 0, ranks)

    def ldata(li):
        lvl = local[li]
        return (fine_mask if li == 0 else lvl["mask"]), lvl["diag"]

    corr = [masked_corrections(ops[li], ldata(li)[0], ranks)
            for li in range(nlev)]

    def masked_apply(li, mask, x):
        Kx = halo(li, ops[li].apply_blocked(mask * x, corrections=corr[li]))
        return mask * Kx + (1.0 - mask) * x

    def smooth(li, x, b, n, x_is_zero=False):
        mask, diag = ldata(li)
        lmax = meta.lam_max[li]
        lmin = lmax / meta.cheb_div[li]
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        if meta.use_patch[li]:
            W, half = repl["levels"][li]["patch_W"], local[li]["half"]

            def pc(v):
                return dist_patch_apply(W, half, mask, v, ranks)
        else:
            dinv = 1.0 / (mask * diag + (1.0 - mask))

            def pc(v):
                return dinv * v
        if x_is_zero:
            x, r = torch.zeros_like(b), b
        else:
            r = b - masked_apply(li, mask, x)
        d = (1.0 / theta) * pc(r)
        sigma = theta / delta
        rho = 1.0 / sigma
        for _ in range(n):
            x = x + d
            r = r - masked_apply(li, mask, d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * pc(r)
            rho = rho_new
        return x + d

    def grid_shape(li):
        return tuple(reversed(meta.local_npts[li]))

    def to_grid(li, x):
        return conv.from_blocked(x, effs[li], grid_shape(li))

    def to_solver(li, g):
        return conv.to_blocked(g, effs[li])

    def subcell_params(li, s, ratio):
        digits = []
        ss = s
        for _ in range(dim):
            digits.append(ss % ratio)
            ss //= ratio
        ncells = meta.local_nelem[li + 1]  # coarse local cells
        step = ratio * (N - 1)
        offset = tuple((N - 1) * dgt for dgt in digits)
        return ncells, step, offset

    def blocks(li):
        s = effs[li] - 1
        return tuple((n - 1) // s + 1 for n in grid_shape(li))

    def transfer(li):
        """(Wt, m, e_lo, e_hi) of a blocked-native jump, or None."""
        tm = meta.tms[li]
        if tm is None or (li == 0 and fine_boundary_free):
            return None
        Wt = repl["levels"][li]["Wt"]
        m, e_lo = tm
        return Wt, m, e_lo, Wt.shape[0] - 1 - e_lo - m

    def restrict(li, res):
        """Fine local residual (blocked) -> coarse (blocked)."""
        lvl = local[li]
        tk = transfer(li)
        if tk is not None:
            # kernel-form restriction: halve interface-plane inputs
            # (ownership shares), compute the downward ghost blocks the
            # tap window can reach, and margin-sum
            Wt, m, e_lo, e_hi = tk
            gl = (m + e_hi) // m
            Bc = blocks(li + 1)
            x = res * lvl["mult_b"] * lvl["half"]
            rc_ext = blocked_restrict_apply(x, Wt, m, e_lo, Bc, dim,
                                            lo_ghost=gl)
            return _margin_sum(rc_ext, gl, 0, Bc[0], ranks)
        ratio = meta.ratios[li]
        interp = repl["levels"][li]["interp"]
        rf = to_grid(li, res) * lvl["mult"]
        rc = rf.new_zeros(grid_shape(li + 1) + (dim,))
        for s in range(ratio**dim):
            ncells, step, offset = subcell_params(li, s, ratio)
            vals = grid_gather(rf, N, ncells, step, offset)
            rc = grid_scatter_add(rc, vals @ interp[s], N,
                                  meta.local_nelem[li + 1], N - 1,
                                  (0,) * dim)
        return halo(li + 1, to_solver(li + 1, rc))

    def prolong(li, xc):
        """Coarse local correction (blocked) -> fine (blocked)."""
        lvl = local[li]
        tk = transfer(li)
        if tk is not None:
            Wt, m, e_lo, e_hi = tk
            Bf = blocks(li)
            xo = xc * local[li + 1]["half"]
            y_ext = blocked_prolong_apply(xo, Wt, m, e_lo, Bf, dim,
                                          lo_ghost=e_lo, hi_ghost=m + e_hi)
            y = _margin_sum(y_ext.contiguous(), e_lo, m + e_hi, Bf[0],
                            ranks)
            return y * lvl["mult_b"]
        ratio = meta.ratios[li]
        interp = repl["levels"][li]["interp"]
        xcg = to_grid(li + 1, xc)
        xce = grid_gather(xcg, N, meta.local_nelem[li + 1], N - 1,
                          (0,) * dim)
        fine = xcg.new_zeros(grid_shape(li) + (dim,))
        for s in range(ratio**dim):
            ncells, step, offset = subcell_params(li, s, ratio)
            fine = grid_scatter_add(fine, xce @ interp[s].T, N, ncells,
                                    step, offset)
        return halo(li, to_solver(li, fine)) * lvl["mult_b"]

    def coarse_solve(r):
        """All-gather -> de-dup -> solve -> this rank's rows.

        The solve is the dense masked inverse (whole hierarchy
        distributed) or the single-device tail V-cycle over the remaining
        levels (meta.aggl): every rank computes the same global coarse
        correction.
        """
        rg = to_grid(nlev - 1, r)  # (rows_loc, ..., dim)
        gathered = ranks.all_gather(rg)
        full = torch.cat([gathered[0]] + [g[1:] for g in gathered[1:]])
        if meta.aggl:
            xg = repl["tail"](conv.to_blocked(full, meta.tail_ngl))
            x = conv.from_blocked(xg, meta.tail_ngl,
                                  tuple(reversed(meta.tail_npts)))
        else:
            x = (repl["coarse_inv"] @ full.reshape(-1)).reshape(full.shape)
        rows = meta.rows_loc[nlev - 1]
        row0 = ranks.coords[0] * (rows - 1)
        return to_solver(nlev - 1, x[row0:row0 + rows])

    def vcycle(li, r):
        mask, _ = ldata(li)
        if li == nlev - 1:
            return coarse_solve(r)
        x = smooth(li, None, r, meta.pre, x_is_zero=True)
        res = mask * (r - masked_apply(li, mask, x))
        mask_c, _ = ldata(li + 1)
        rc = mask_c * restrict(li, res)
        xc = vcycle(li + 1, rc)
        x = x + mask * prolong(li, xc)
        return smooth(li, x, r, meta.post)

    def minv(r):
        return vcycle(0, r)

    return minv
