"""Carry the reference package's arrays across to this port.

Every function takes the JAX package's arrays as numpy (``np.asarray``
of a jax array) and builds the port's counterpart on ``device`` (None:
the card); nothing here imports JAX. The cross-package tests use them to start the port
from the reference's own operators and state.
"""

import numpy as np
import torch

from pynama_tpu_torch.device import resolve_device
from pynama_tpu_torch.ops.assembly import make_element_op
from pynama_tpu_torch.ops.structured import StructuredElementOp
from pynama_tpu_torch.parallel.unstructured import cell_range


def _t(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype,
                        device=resolve_device(device))


def structured_op(A, ngl, nelem, npts, k_in, k_out, sb=1,
                  dtype=torch.float64, device=None):
    """A StructuredElementOp from an elemental matrix A
    (``np.asarray(jax_op.A)``) and the reference op's shape fields."""
    return StructuredElementOp(A=_t(A, dtype, device), ngl=ngl,
                               nelem=tuple(nelem), npts=tuple(npts),
                               k_in=k_in, k_out=k_out, sb=sb)


def element_op(A, in_dofs, out_dofs, out_size, dtype=torch.float64,
               device=None):
    """An ElementOp from the reference ElementOp's fields
    (``np.asarray(op.A)``, ``op.in_dofs``, ``op.out_dofs``,
    ``op.out_size``)."""
    return make_element_op(np.asarray(A), np.asarray(in_dofs),
                           np.asarray(out_dofs), int(out_size), dtype,
                           device)


def blocked_masks(problem, arrays, dtype=None):
    """Set a set-up problem's blocked masks/BC constants from the
    reference problem's (``{"free_mask_b": np.asarray(ref.free_mask_b),
    ...}``); shapes must match the port's."""
    dtype = dtype or problem.dtype
    for name, a in arrays.items():
        cur = getattr(problem, name)
        if tuple(cur.shape) != tuple(np.shape(a)):
            raise ValueError(f"{name}: reference shape {np.shape(a)}, port "
                             f"shape {tuple(cur.shape)}")
        setattr(problem, name, _t(a, dtype, problem.device))


def run_state(vort, vel_pair, f1, t, dt, dtype=torch.float64, device=None):
    """The run state ``(vort, (vel_fs, vel), f1, t, dt)`` of a blocked
    reference run as tensors (t, dt as Python floats)."""
    vel_fs, vel = vel_pair
    return (_t(vort, dtype, device),
            (_t(vel_fs, dtype, device), _t(vel, dtype, device)),
            _t(f1, dtype, device), float(t), float(dt))


def stacked_to_rank(x_stacked, pgrid, rank, dtype=torch.float64,
                    device=None):
    """Rank ``rank``'s part of the reference's device-stacked arrays
    (leading axes ``pgrid``: ``ShardedNSProblem.shard``'s output,
    ``build_dist_mg``'s stacked pytree), as tensors: the block at
    ``np.unravel_index(rank, pgrid)``. Dicts, lists and tuples are
    mapped through."""
    if isinstance(x_stacked, dict):
        return {k: stacked_to_rank(v, pgrid, rank, dtype, device)
                for k, v in x_stacked.items()}
    if isinstance(x_stacked, (list, tuple)):
        return type(x_stacked)(stacked_to_rank(v, pgrid, rank, dtype,
                                               device) for v in x_stacked)
    here = np.unravel_index(rank, tuple(pgrid))
    return _t(np.asarray(x_stacked)[here], dtype, device)


def ibm_windows(nodes, weights, dtype=torch.float64, device=None):
    """The reference coupling's windows ``(nodes, weights)``
    (``IBMCoupling.windows``) as the port's: int64 node ids and weights
    of ``dtype``."""
    return (torch.tensor(np.asarray(nodes), dtype=torch.int64,
                         device=resolve_device(device)),
            _t(weights, dtype, device))


def chunk_tables_to_rank(chunks, n_cells, rank, dtype=torch.float64,
                         device=None):
    """Rank ``rank``'s ``(A, in_dofs, out_dofs)`` from the reference's
    chunk tables (``ShardedUnstructuredProblem.K_c`` and the like: A
    (P, E_loc, out_k, in_k), in_dofs (P, E_loc, in_k), out_dofs (P,
    E_loc, out_k)) of a mesh of ``n_cells`` cells, the padding rows
    dropped: A of ``dtype``, the dof tables int64."""
    A, in_dofs, out_dofs = (np.asarray(x)[rank] for x in chunks)
    lo, hi = cell_range(n_cells, len(chunks[0]), rank)
    n = hi - lo
    device = resolve_device(device)

    def idx(a):
        return torch.as_tensor(a[:n].astype(np.int64), device=device)

    return _t(A[:n], dtype, device), idx(in_dofs), idx(out_dofs)
