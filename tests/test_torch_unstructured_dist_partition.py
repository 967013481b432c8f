"""The cell partition of parallel/unstructured.py against the reference's
``_chunk_tables``, bit for bit: each rank's rows are the reference's
chunk without its padding rows (zero matrices scattering into dof 0),
a shared elemental matrix stays shared, and convert.chunk_tables_to_rank
gives the same tables from the reference's stacked ones. No ranks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.parallel.unstructured import _chunk_tables
from pynama_tpu_torch.convert import chunk_tables_to_rank
from pynama_tpu_torch.mesh.structured import BoxMesh
from pynama_tpu_torch.ops.assembly import ElementOp
from pynama_tpu_torch.parallel.unstructured import cell_range, chunk_tables

N_DEV = 4


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "batched"])
@pytest.mark.parametrize("nelem", [(4, 4), (17, 1), (3, 1)],
                         ids=["E16", "E17", "E3"])
def test_chunk_tables_match_reference(nelem, shared):
    m = BoxMesh(nelem=nelem, lower=(0, 0), upper=(1, 1), ngl=3)
    E = m.n_cells
    in_dofs, out_dofs = m.cell_dofs(2), m.cell_dofs(1)
    rng = np.random.default_rng(E)
    shape = (out_dofs.shape[1], in_dofs.shape[1])
    A = rng.normal(size=shape if shared else (E,) + shape)
    ref = [np.asarray(x) for x in _chunk_tables(A, in_dofs, out_dofs, N_DEV,
                                                jnp.float64)]
    ranges = [cell_range(E, N_DEV, r) for r in range(N_DEV)]
    assert ranges[0][0] == 0 and ranges[-1][1] == E
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    for rank, (lo, hi) in enumerate(ranges):
        n = hi - lo
        A_r, in_r, out_r = chunk_tables(A, in_dofs, out_dofs, N_DEV, rank)
        assert (A_r.ndim == 2) == shared
        A_rows = np.broadcast_to(A_r, (n,) + shape)
        assert np.array_equal(A_rows, ref[0][rank, :n])
        assert np.array_equal(in_r, ref[1][rank, :n])
        assert np.array_equal(out_r, ref[2][rank, :n])
        # what the reference adds past them is padding: zero matrices
        # that scatter into dof 0
        assert not ref[0][rank, n:].any() and not ref[2][rank, n:].any()
        tA, t_in, t_out = chunk_tables_to_rank(ref, E, rank, device="cpu")
        assert torch.equal(tA, torch.tensor(A_rows))
        assert t_in.dtype == t_out.dtype == torch.int64
        assert np.array_equal(t_in.numpy(), in_r)
        assert np.array_equal(t_out.numpy(), out_r)
        # a rank without cells applies to a zero vector
        if n == 0:
            op = ElementOp(torch.as_tensor(A_r), t_in, t_out, m.n_nodes)
            y = op(torch.ones(m.n_nodes * 2, dtype=torch.float64))
            assert y.shape == (m.n_nodes,) and not y.any()
    if E == 3:
        assert ranges[-1] == (3, 3)
