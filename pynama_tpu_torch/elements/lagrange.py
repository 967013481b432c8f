"""1D Lagrange interpolation basis (setup-time, host numpy, float64).

Behavioral parity: upstream Pynama src/elements/element.py:17-49
(interpFun1D). Values and first derivatives of the Lagrange cardinal
functions on arbitrary nodes, evaluated at arbitrary points.
"""

import numpy as np


def lagrange_basis(nodes, pts):
    """Evaluate the Lagrange basis on ``nodes`` at ``pts``.

    Returns ``(h, dh)`` with shape ``(len(pts), len(nodes))`` where
    ``h[q, j] = l_j(pts[q])`` and ``dh[q, j] = l'_j(pts[q])``.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    pts = np.asarray(pts, dtype=np.float64)
    n = nodes.size
    m = pts.size

    denom = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(denom, 1.0)
    denom_prod = np.prod(denom, axis=1)  # prod_{k != j} (x_j - x_k)

    h = np.empty((m, n))
    dh = np.empty((m, n))
    for q in range(m):
        diff = pts[q] - nodes
        for j in range(n):
            others = np.delete(diff, j)
            h[q, j] = np.prod(others) / denom_prod[j]
            # l'_j(x) = sum_l prod_{k != j,l} (x - x_k) / prod_{k != j}(x_j - x_k)
            s = 0.0
            for ell in range(n):
                if ell == j:
                    continue
                keep = np.ones(n, dtype=bool)
                keep[j] = False
                keep[ell] = False
                s += np.prod(diff[keep])
            dh[q, j] = s / denom_prod[j]
    return h, dh
