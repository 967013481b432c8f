"""Elemental operators on uniform grids as blocked stencil contractions.

Port of pynama_tpu/ops/conv.py. On a uniform box mesh an assembled
spectral-element operator is a periodic stencil: blocking the node grid
by parity (period P = ngl-1 per axis) turns gather -> elemental GEMM ->
scatter-add into one dense contraction

    y_blocked = conv(x_blocked, W),   W: (F,)*dim x (P^dim k_in) x (P^dim k_out)

computed by the hand-written kernel behind ``stencil.conv_blocked``.

Boundary exactness: the contraction also sums over "phantom" cells
outside the mesh; their contributions touch only boundary node planes
and are removed exactly by inclusion-exclusion over pinned axes (2D: 4
face corrections, 1D sub-plane stencils, and 4 corner matrices). The
sub-plane corrections are small matmul tap loops (``conv_taps``), as in
the reference, where they run outside the Pallas kernel.

Kernel construction is host numpy on a concrete elemental matrix; the
apply side works on tensors of any device.
"""

from functools import lru_cache
from itertools import combinations, product

import numpy as np
import torch
import torch.nn.functional as tnf

from pynama_tpu_torch.ops import stencil


@lru_cache(maxsize=None)
def _kernel_indices(ngl: int, dim: int, k_out: int, k_in: int,
                    ext: int = None):
    """Flat scatter indices building W from A.reshape(-1).

    A flat layout: ((l_nodes, k_out), (m_nodes, k_in)) row-major with
    local node lexicographic x fastest, i.e. node axes in GRID ORDER
    (slowest spatial axis first) when reshaped to (E,)*dim.
    Returns (w_idx, w_shape): W.reshape(-1)[w_idx] += A.reshape(-1).
    W shape: (F,)*dim + (P^dim*k_in, P^dim*k_out).

    ext: local node extent E per axis (default ngl — ordinary elements);
    E > ngl describes overlapping windows (vertex-star patches,
    E = 2*ngl-1) with a wider footprint F = 2*((E-1)//P)+1.
    """
    N, P = ngl, ngl - 1
    E = N if ext is None else ext
    maxblk = (E - 1) // P
    F = 2 * maxblk + 1
    nnode = E**dim
    Cin, Cout = P**dim * k_in, P**dim * k_out
    w_shape = (F,) * dim + (Cin, Cout)

    ids = np.arange(nnode)
    digs = []
    for ax in range(dim):  # axis 0 slowest
        digs.append((ids // (E ** (dim - 1 - ax))) % E)
    digs = np.stack(digs)                     # (dim, nnode)
    blk = digs // P                           # 0 .. maxblk
    sub = digs % P

    def chan(subs, k):
        c = np.zeros(nnode, dtype=np.int64)
        for ax in range(dim):
            c = c * P + subs[ax]
        return c * k

    co_node = chan(sub, k_out)
    ci_node = chan(sub, k_in)

    l = ids[:, None]                          # out node
    m = ids[None, :]                          # in node
    q = np.zeros((nnode, nnode), dtype=np.int64)
    for ax in range(dim):
        q = q * F + (blk[ax][m] - blk[ax][l] + maxblk)
    cell = (q * Cin + ci_node[m]) * Cout + co_node[l]   # (nnode, nnode)

    ko = np.arange(k_out)
    ki = np.arange(k_in)
    w_idx = (cell[:, None, :, None]
             + ki[None, None, None, :] * Cout
             + ko[None, :, None, None])
    return w_idx.reshape(-1), w_shape


def _build_kernel(A, ngl, dim, k_out, k_in, dtype, ext=None):
    """numpy W in ``dtype`` (a numpy dtype), summed in float64."""
    w_idx, w_shape = _kernel_indices(ngl, dim, k_out, k_in, ext)
    W = np.zeros(int(np.prod(w_shape)), dtype=np.float64)
    np.add.at(W, w_idx, np.asarray(A, dtype=np.float64).reshape(-1))
    return W.reshape(w_shape).astype(np.dtype(dtype))


def _pin(A, ngl, dim, k_out, k_in, pins):
    """Contract the elemental matrix at pinned axes.

    pins: dict {grid_axis: side} with side 0 = lo boundary (phantom cell
    below: pinned local index N-1), 1 = hi (pinned local index 0).
    Returns (A_sub, rem_axes), A_sub an elemental matrix over the
    remaining axes (grid order preserved).
    """
    N = ngl
    At = np.asarray(A).reshape((N,) * dim + (k_out,) + (N,) * dim + (k_in,))
    idx = []
    for ax in range(dim):  # l axes
        idx.append((N - 1 if pins[ax] == 0 else 0) if ax in pins
                   else slice(None))
    idx.append(slice(None))
    for ax in range(dim):  # m axes
        idx.append((N - 1 if pins[ax] == 0 else 0) if ax in pins
                   else slice(None))
    idx.append(slice(None))
    A_sub = At[tuple(idx)]
    rem = [ax for ax in range(dim) if ax not in pins]
    n_rem = N ** len(rem)
    return A_sub.reshape(n_rem * k_out, n_rem * k_in), rem


def build_conv_kernels(A, ngl, dim, k_out, k_in, dtype):
    """Main kernel + boundary corrections for an elemental matrix (numpy).

    Returns (W, corrections); corrections is a tuple of
    (pins, sign, W_sub) where pins = ((grid_axis, side), ...) and W_sub
    is a (dim-|pins|)-dim kernel (or a (k_in, k_out) matrix when every
    axis is pinned).
    """
    W = _build_kernel(A, ngl, dim, k_out, k_in, dtype)
    corrections = []
    for r in range(1, dim + 1):
        sign = float((-1) ** r)
        for S in combinations(range(dim), r):
            for sides in product((0, 1), repeat=r):
                pins = dict(zip(S, sides))
                A_sub, rem = _pin(A, ngl, dim, k_out, k_in, pins)
                if rem:
                    W_sub = _build_kernel(A_sub, ngl, len(rem), k_out,
                                          k_in, dtype)
                else:
                    W_sub = A_sub.T  # (k_in, k_out)
                corrections.append((tuple(sorted(pins.items())), sign, W_sub))
    return W, tuple(corrections)


def build_patch_kernel(Bmat, ngl, dim, k, dtype):
    """Kernel of a vertex-star additive-Schwarz smoother (numpy).

    Bmat: (((2P+1)^dim)*k)^2 patch matrix (the inverse patch stiffness),
    local nodes in grid order. Returns a footprint-5 kernel W computing
    y = sum_p R_p^T Bmat R_p x over all window positions. No boundary
    corrections on purpose: phantom windows add a PSD term.
    """
    ext = 2 * (ngl - 1) + 1
    return _build_kernel(Bmat, ngl, dim, k, k, dtype, ext=ext)


@lru_cache(maxsize=None)
def _rebase_map(Fp, dim, P, k_in, k_out, f):
    """Gather map re-indexing a period-P kernel onto period s=f*P.

    Parity block bp = bs*f + u, so a parity displacement d lands in super
    block bs + floor((u_out+d)/f) at sub-position (u_out+d) mod f.
    Returns (src_map, w_shape): dst entry i takes W_p.flat[src[i]] (or 0
    where src < 0).
    """
    Qp = (Fp - 1) // 2
    s = f * P
    all_ds = [(u + d) // f for u in range(f) for d in range(-Qp, Qp + 1)]
    Qs = max(max(all_ds), -min(all_ds))
    Fs = 2 * Qs + 1
    Cp_in, Cp_out = P**dim * k_in, P**dim * k_out
    Cs_in, Cs_out = s**dim * k_in, s**dim * k_out
    mp = np.full(Fs**dim * Cs_in * Cs_out, -1, dtype=np.int64)

    subs = np.array(list(np.ndindex(*(P,) * dim)), dtype=np.int64)
    subs = subs.reshape(-1, dim)

    def chan_sup(u, k):
        lin = np.zeros(len(subs), dtype=np.int64)
        for ax in range(dim):
            lin = lin * s + (u[ax] * P + subs[:, ax])
        return (lin[:, None] * k + np.arange(k)).reshape(-1)

    lin_p = np.zeros(len(subs), dtype=np.int64)
    for ax in range(dim):
        lin_p = lin_p * P + subs[:, ax]

    def chan_par(k):
        return (lin_p[:, None] * k + np.arange(k)).reshape(-1)

    cin_p, cout_p = chan_par(k_in), chan_par(k_out)
    for u_out in np.ndindex(*(f,) * dim):
        co_s = chan_sup(u_out, k_out)
        for dq in np.ndindex(*(Fp,) * dim):
            ds = [(u_out[a] + dq[a] - Qp) // f for a in range(dim)]
            u_in = tuple((u_out[a] + dq[a] - Qp) % f for a in range(dim))
            qs_lin = qp_lin = 0
            for a in range(dim):
                qs_lin = qs_lin * Fs + (ds[a] + Qs)
                qp_lin = qp_lin * Fp + dq[a]
            ci_s = chan_sup(u_in, k_in)
            dst = (qs_lin * Cs_in + ci_s)[:, None] * Cs_out + co_s[None, :]
            src = (qp_lin * Cp_in + cin_p)[:, None] * Cp_out + cout_p[None, :]
            mp[dst.reshape(-1)] = src.reshape(-1)
    return mp, (Fs,) * dim + (Cs_in, Cs_out)


def rebase_conv_kernel(W, f, dim, k_in, k_out, ngl):
    """Re-block a period-(ngl-1) numpy kernel onto period f*(ngl-1)."""
    if f == 1:
        return W
    P = ngl - 1
    Fp = W.shape[0]
    mp, shape = _rebase_map(Fp, dim, P, k_in, k_out, f)
    flat = np.asarray(W).reshape(-1)
    out = np.where(mp >= 0, flat[np.maximum(mp, 0)], 0.0).astype(W.dtype)
    return out.reshape(shape)


def rebase_kernels(W, corrections, f, dim, k_in, k_out, ngl):
    """Rebase a (W, corrections) pair from build_conv_kernels."""
    if f == 1:
        return W, corrections
    W_s = rebase_conv_kernel(W, f, dim, k_in, k_out, ngl)
    corr_s = []
    for pins, sign, W_sub in corrections:
        n_rem = dim - len(pins)
        if n_rem:
            W_sub = rebase_conv_kernel(W_sub, f, n_rem, k_in, k_out, ngl)
        corr_s.append((pins, sign, W_sub))
    return W_s, tuple(corr_s)


def kernels_to(W, corrections, device, dtype):
    """numpy (W, corrections) -> contiguous tensors on ``device``."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return t(W), tuple((pins, sign, t(W_sub))
                       for pins, sign, W_sub in corrections)


# ----------------------------------------------------------------------
# apply
# ----------------------------------------------------------------------
def conv_taps(xb, W):
    """Small stencil contraction as F^dim shifted matmuls, any device.

    Carries the (dim-1)-dimensional phantom-plane corrections, which the
    reference also computes outside its Pallas kernel.
    """
    dim = W.dim() - 2
    F = W.shape[0]
    Q = (F - 1) // 2
    B = xb.shape[-dim - 1:-1]
    g = tnf.pad(xb, (0, 0) + (Q, Q) * dim)
    out = None
    for q in product(range(F), repeat=dim):
        sl = (Ellipsis,) + tuple(
            slice(q[i], q[i] + B[i]) for i in range(dim)) + (slice(None),)
        v = torch.matmul(g[sl], W[q])
        if out is None:
            out = v
        else:
            out += v
    return out


def _to_blocked(x, ngl, npts_grid):
    """(npts..., k) -> ((B..., P^dim*k) parity-blocked tensor, B)."""
    P = ngl - 1
    dim = len(npts_grid)
    B = tuple((n - 1) // P + 1 for n in npts_grid)
    k = x.shape[-1]
    pads = (0, 0)
    for i in reversed(range(dim)):
        pads += (0, B[i] * P - npts_grid[i])
    g = tnf.pad(x, pads)
    shape = ()
    for b in B:
        shape += (b, P)
    g = g.reshape(shape + (k,))
    perm = (tuple(range(0, 2 * dim, 2)) + tuple(range(1, 2 * dim, 2))
            + (2 * dim,))
    return g.permute(perm).reshape(B + (P**dim * k,)), B


def _from_blocked(y, ngl, npts_grid, k_out):
    P = ngl - 1
    dim = len(npts_grid)
    B = tuple(y.shape[:dim])
    g = y.reshape(B + (P,) * dim + (k_out,))
    perm = []
    for i in range(dim):
        perm += [i, dim + i]
    perm.append(2 * dim)
    g = g.permute(perm).reshape(tuple(b * P for b in B) + (k_out,))
    return g[tuple(slice(0, n) for n in npts_grid) + (slice(None),)]


def blocked_shape(ngl, npts_grid, k):
    P = ngl - 1
    dim = len(npts_grid)
    return tuple((n - 1) // P + 1 for n in npts_grid) + (P**dim * k,)


def to_blocked(grid, ngl):
    """(npts..., k) node grid -> (B..., P^dim*k) parity-blocked tensor."""
    return _to_blocked(grid, ngl, tuple(grid.shape[:-1]))[0]


def from_blocked(xb, ngl, npts_grid):
    P = ngl - 1
    dim = len(npts_grid)
    k = xb.shape[-1] // (P**dim)
    return _from_blocked(xb, ngl, npts_grid, k).contiguous()


def to_blocked_np(grid, ngl):
    """numpy twin of to_blocked (host-side setup)."""
    P = ngl - 1
    npts_grid = grid.shape[:-1]
    dim = len(npts_grid)
    B = tuple((n - 1) // P + 1 for n in npts_grid)
    k = grid.shape[-1]
    pads = tuple((0, B[i] * P - npts_grid[i]) for i in range(dim)) + ((0, 0),)
    g = np.pad(np.asarray(grid), pads)
    shape = ()
    for b in B:
        shape += (b, P)
    g = g.reshape(shape + (k,))
    perm = (tuple(range(0, 2 * dim, 2)) + tuple(range(1, 2 * dim, 2))
            + (2 * dim,))
    return g.transpose(perm).reshape(B + (P**dim * k,))


@lru_cache(maxsize=None)
def _pad_mask_np(ngl, npts_grid, k):
    """(B..., P^dim*k) numpy: 1.0 on real node slots, 0.0 on pad slots."""
    P = ngl - 1
    dim = len(npts_grid)
    axes = []
    for n in npts_grid:
        B = (n - 1) // P + 1
        axes.append((np.arange(B * P) < n).astype(np.float64).reshape(B, P))
    out = axes[0]
    for m in axes[1:]:
        out = np.multiply.outer(out, m)
    perm = tuple(range(0, 2 * dim, 2)) + tuple(range(1, 2 * dim, 2))
    out = out.transpose(perm)
    B = out.shape[:dim]
    out = out.reshape(B + (P**dim,))
    return np.repeat(out, k, axis=-1)


def pad_mask(ngl, npts_grid, k):
    return _pad_mask_np(ngl, tuple(npts_grid), k)


@lru_cache(maxsize=64)
def pad_mask_tensor(ngl, npts_grid, k, device, dtype):
    """pad_mask as a tensor, made once per (shape, device, dtype)."""
    return torch.as_tensor(pad_mask(ngl, npts_grid, k), dtype=dtype,
                           device=device)


def mask_frees_boundary(mask, ngl, npts_grid):
    """Does a free-dof mask (numpy) leave ANY boundary-plane dof free?

    Accepts grid or blocked layout. Decided once on the host when a
    system or V-cycle is built: the phantom-cell corrections can be
    skipped inside fully-Dirichlet masked operators.
    """
    m = np.asarray(mask)
    dim = len(npts_grid)
    if m.shape[:dim] == tuple(npts_grid):         # grid layout
        for ax in range(dim):
            for side in (0, -1):
                idx = [slice(None)] * m.ndim
                idx[ax] = side
                if np.any(m[tuple(idx)] != 0.0):
                    return True
        return False
    P = ngl - 1
    B = m.shape[:dim]
    k = m.shape[-1] // P**dim
    mr = m.reshape(B + (P,) * dim + (k,))
    for ax in range(dim):
        for blk in (0, B[ax] - 1):                # boundary = (blk, sub 0)
            idx = [slice(None)] * mr.ndim
            idx[ax] = blk
            idx[dim + ax] = 0
            if np.any(mr[tuple(idx)] != 0.0):
                return True
    return False


def conv_stencil_apply_blocked(xb, W, corrections, ngl, npts_grid, k_out):
    """Blocked-in/blocked-out apply: kernel + boundary corrections + pad mask.

    xb: (B..., P^dim*k_in) with ZERO pad slots (an invariant every blocked
    producer keeps; the result re-zeroes its own pad slots).
    """
    P = ngl - 1
    dim = len(npts_grid)
    npts_grid = tuple(npts_grid)
    yb = stencil.conv_blocked(xb, W)
    yb = yb * pad_mask_tensor(ngl, npts_grid, k_out, yb.device, yb.dtype)
    if not corrections:
        return yb
    B = tuple(yb.shape[:dim])
    k_in = xb.shape[-1] // (P**dim)
    xr = xb.reshape(B + (P,) * dim + (k_in,))
    yr = yb.reshape(B + (P,) * dim + (k_out,))  # view: updated in place
    for pins, sign, W_sub in corrections:
        pind = dict(pins)
        # boundary plane: pinned axes at block 0 (lo) / B-1 (hi), sub 0
        idx = tuple(
            (0 if pind[ax] == 0 else B[ax] - 1) if ax in pind
            else slice(None) for ax in range(dim)
        ) + tuple(0 if ax in pind else slice(None) for ax in range(dim)) \
            + (slice(None),)
        xs = xr[idx]
        rem = [ax for ax in range(dim) if ax not in pind]
        if rem:
            B_rem = tuple(B[ax] for ax in rem)
            cs = conv_taps(xs.reshape(B_rem + (P**len(rem) * k_in,)), W_sub)
            # pad slots of the sub-plane must not receive corrections
            sub_npts = tuple(npts_grid[ax] for ax in rem)
            cs = cs * pad_mask_tensor(ngl, sub_npts, k_out, cs.device,
                                      cs.dtype)
            cs = cs.reshape(B_rem + (P,) * len(rem) + (k_out,))
        else:
            cs = xs @ W_sub
        yr[idx] += sign * cs
    return yb


def conv_stencil_apply(x, W, corrections, ngl, npts_grid, k_out):
    """y = assembled_operator(x) on a node grid (npts_grid..., k_in).

    Returns (npts_grid..., k_out); exact at boundaries via the phantom
    corrections from build_conv_kernels.
    """
    dim = len(npts_grid)
    xb, _ = _to_blocked(x, ngl, npts_grid)
    y = _from_blocked(stencil.conv_blocked(xb, W), ngl, npts_grid,
                      k_out).contiguous()
    for pins, sign, W_sub in corrections:
        pin_axes = [ax for ax, _ in pins]
        rem = [ax for ax in range(dim) if ax not in pin_axes]
        idx = [slice(None)] * (dim + 1)
        for ax, side in pins:
            idx[ax] = 0 if side == 0 else npts_grid[ax] - 1
        idx = tuple(idx)
        xs = x[idx]
        if rem:
            sub_npts = tuple(npts_grid[ax] for ax in rem)
            xsb, _ = _to_blocked(xs, ngl, sub_npts)
            cs = _from_blocked(conv_taps(xsb, W_sub), ngl, sub_npts, k_out)
        else:
            cs = xs @ W_sub
        y[idx] += sign * cs
    return y
