"""1D quadrature rules (setup-time, host numpy, float64).

Behavioral parity: upstream Pynama src/elements/utilities.py:43-92
(gaussPoints / lobattoPoints). Both are textbook algorithms: Golub-Welsch
for Gauss-Legendre, Newton iteration on the Legendre recurrence for
Gauss-Lobatto-Legendre. Points ascending on [-1, 1], weights sum to 2.
"""

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def gauss_points(n: int):
    """Gauss-Legendre nodes and weights on [-1, 1].

    Exact for polynomials of degree 2n-1.
    """
    if n < 1:
        raise ValueError("need at least one quadrature point")
    if n == 1:
        return np.zeros(1), np.full(1, 2.0)
    k = np.arange(1, n, dtype=np.float64)
    beta = k / np.sqrt(4.0 * k * k - 1.0)
    T = np.diag(beta, 1) + np.diag(beta, -1)
    vals, vecs = np.linalg.eigh(T)
    order = np.argsort(vals)
    x = vals[order]
    w = 2.0 * vecs[0, order] ** 2
    # Symmetrize to kill eigensolver noise (points/weights are symmetric).
    x = (x - x[::-1]) / 2.0
    w = (w + w[::-1]) / 2.0
    x.setflags(write=False)
    w.setflags(write=False)
    return x, w


@lru_cache(maxsize=None)
def lobatto_points(n: int):
    """Gauss-Lobatto-Legendre nodes and weights on [-1, 1].

    Includes the endpoints; exact for polynomials of degree 2n-3. The GLL
    nodes double as the spectral element's nodal points.
    """
    if n < 2:
        raise ValueError("GLL rule needs at least two points")
    if n == 2:
        x = np.array([-1.0, 1.0])
        w = np.array([1.0, 1.0])
    else:
        # Chebyshev-Gauss-Lobatto initial guess, Newton on P'_{n-1} roots.
        x = -np.cos(np.pi * np.arange(n, dtype=np.float64) / (n - 1))
        P = np.zeros((n, n))
        x_old = np.full(n, 2.0)
        while np.max(np.abs(x - x_old)) > 1e-15:
            x_old = x.copy()
            P[:, 0] = 1.0
            P[:, 1] = x
            for k in range(2, n):
                P[:, k] = ((2 * k - 1) * x * P[:, k - 1] - (k - 1) * P[:, k - 2]) / k
            x = x_old - (x * P[:, n - 1] - P[:, n - 2]) / (n * P[:, n - 1])
        w = 2.0 / ((n - 1) * n * P[:, n - 1] ** 2)
        x = (x - x[::-1]) / 2.0
        w = (w + w[::-1]) / 2.0
    x.setflags(write=False)
    w.setflags(write=False)
    return x, w
