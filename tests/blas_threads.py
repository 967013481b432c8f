"""``blas_threads(n)``: numpy's BLAS limited to n threads inside the
block (threadpoolctl), or unchanged where threadpoolctl is missing."""

import contextlib

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # pragma: no cover
    threadpool_limits = None


def blas_threads(n):
    if threadpool_limits is None:
        return contextlib.nullcontext()
    return threadpool_limits(n, user_api="blas")
