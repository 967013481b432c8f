"""Preconditioned conjugate gradients.

Port of pynama_tpu/solvers/cg.py. The reference runs the iteration in
``lax.while_loop`` on the device; here it is a Python loop that reads
``rr > tol2`` on the host once per iteration (one device sync each).
Every inner product goes through ``dot``, so the same loop runs over a
distributed vector with an all-reduced dot (parallel/slab.py
``make_pdot``).
"""

import math
from typing import Callable, NamedTuple, Optional

import torch


def sumdot(a, b):
    """Layout-agnostic inner product (flat vectors, grids, blocked)."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: torch.Tensor


def cg_solve(
    apply_A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    m_inv=None,
    rtol: float = 1e-12,
    atol: float = 0.0,
    maxiter: int = 10000,
    dot: Callable = sumdot,
) -> CGResult:
    """Solve A x = b with preconditioned CG.

    m_inv: a diagonal tensor (Jacobi), a callable z = M^{-1}(r) (e.g. a
    multigrid V-cycle), or None. Stops when ||r||_2 <= max(rtol*||b||,
    atol) or after maxiter iterations; every norm and inner product,
    ||b|| too, is ``dot``'s.
    """
    x = torch.zeros_like(b) if x0 is None else x0
    if m_inv is None:
        apply_M = lambda r: r  # noqa: E731
    elif callable(m_inv):
        apply_M = m_inv
    else:
        apply_M = lambda r: m_inv * r  # noqa: E731

    tol = max(rtol * math.sqrt(float(dot(b, b))), atol)
    tol2 = tol * tol

    r = b - apply_A(x)
    rr = dot(r, r)
    rr_host = float(rr)
    # warm starts often satisfy the tolerance outright: skip the
    # preconditioner apply (a whole V-cycle) for a 0-iteration solve
    z = apply_M(r) if rr_host > tol2 else torch.zeros_like(r)
    rz = dot(r, z)
    p = z
    k = 0
    while rr_host > tol2 and k < maxiter:
        Ap = apply_A(p)
        pAp = dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, 1.0, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
        rr = dot(r, r)
        k += 1
        rr_host = float(rr)
    return CGResult(x=x, iters=k, resnorm=torch.sqrt(rr))
