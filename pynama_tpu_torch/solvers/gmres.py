"""Restarted GMRES(m), left-preconditioned, modified Gram-Schmidt.

Port of pynama_tpu/solvers/gmres.py for the KLE's ``kle-solver: gmres``.
The Arnoldi basis is an (m+1, n) buffer on the device. The reference
solves each restart's (m+1) x m least-squares problem on the device with
``jnp.linalg.lstsq`` (SVD, rank-deficient allowed); here it goes to the
host in float64, to numpy's lstsq (SVD as well), because torch's only
CUDA driver assumes full rank. The restart loop reads the residual on
the host once per restart, as ``cg_solve`` reads its own per iteration.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class GMRESResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: torch.Tensor


def gmres_solve(
    apply_A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    m_inv=None,
    restart: int = 30,
    rtol: float = 1e-8,
    maxiter: int = 1000,
) -> GMRESResult:
    """Solve A x = b (flat vectors) with left-preconditioned GMRES(m).

    m_inv: a diagonal tensor, a callable z = M^{-1}(r), or None. Stops
    when ||M^{-1}(b - A x)|| <= rtol ||M^{-1} b|| or after maxiter
    iterations; ``iters`` counts m per restart, as the
    reference does.
    """
    n = b.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    if m_inv is None:
        apply_M = lambda r: r  # noqa: E731
    elif callable(m_inv):
        apply_M = m_inv
    else:
        apply_M = lambda r: m_inv * r  # noqa: E731
    m = restart
    tol = rtol * float(torch.linalg.norm(apply_M(b)))

    def arnoldi_cycle(x):
        r = apply_M(b - apply_A(x))
        beta = torch.linalg.norm(r)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / torch.where(beta == 0, 1.0, beta)
        H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
        for j in range(m):
            w = apply_M(apply_A(V[j]))
            for i in range(j + 1):  # rows past j are zero
                h = torch.dot(V[i], w)
                w = w - h * V[i]
                H[i, j] = h
            hn = torch.linalg.norm(w)
            H[j + 1, j] = hn
            V[j + 1] = w / torch.where(hn == 0, 1.0, hn)
        # min || beta e1 - H y ||, on the host in float64
        e1 = np.zeros(m + 1)
        e1[0] = float(beta)
        y, *_ = np.linalg.lstsq(H.cpu().double().numpy(), e1, rcond=None)
        x = x + V[:m].T @ torch.as_tensor(y, dtype=b.dtype, device=b.device)
        return x, torch.linalg.norm(apply_M(b - apply_A(x)))

    res = torch.linalg.norm(apply_M(b - apply_A(x)))
    k = 0
    while float(res) > tol and k < maxiter:
        x, res = arnoldi_cycle(x)
        k += m
    return GMRESResult(x=x, iters=k, resnorm=res)
