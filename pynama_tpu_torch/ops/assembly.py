"""Matrix-free elemental operators: gather -> GEMM -> scatter-add.

Port of pynama_tpu/ops/assembly.py, the operators of unstructured (Gmsh)
meshes: a per-element dof gather, one shared GEMM (every element has the
same matrix) or a batched product (per-element geometry), and a
scatter-add back to the global vector. All plain torch, as the reference
is plain jnp outside any Pallas kernel.

Shared nodes make the scatter's output indices collide. ``index_add_``
on a CUDA tensor sums colliding values with atomics in any order, so CG
residuals and iteration counts could change from run to run. The scatter
here is a gather instead: at setup every output dof gets the sorted list
of the element slots that feed it, padded to the longest list with a slot
that holds zero, and the apply sums each row of that table. The sum runs
in the same order on every call and on every device.
``index_put_(accumulate=True)`` is deterministic too, but sorts its ids
on every call: with it a step of chip_smoke.py's 128x128 Gmsh cavity
(14a) took 17.1-18.6 s on an H100 against the table's 5.3-5.6 s. The
table serves every scatter whose ids are fixed at setup (here,
solvers/schwarz.py and ops/structured.py); ids that move at run time
(ibm/coupling.py's spread) take ``index_put_``.
"""

import numpy as np
import torch

from pynama_tpu_torch.device import resolve_device


def contributor_table(out_dofs, out_size):
    """(out_size, C) int64 table of the flat slots of ``out_dofs``
    (E, k) that feed each output dof, in increasing slot order, padded
    with the slot E*k (a zero appended by the apply). Slots whose dof is
    outside [0, out_size) are dropped."""
    flat = np.asarray(out_dofs, dtype=np.int64).reshape(-1)
    slots = np.nonzero((flat >= 0) & (flat < out_size))[0]
    order = slots[np.argsort(flat[slots], kind="stable")]
    dofs = flat[order]
    counts = np.bincount(dofs, minlength=out_size)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(order)) - starts[dofs]
    table = np.full((out_size, max(int(counts.max(initial=0)), 1)),
                    flat.size, dtype=np.int64)
    table[dofs, rank] = order
    return table


def scatter_add(values, table):
    """Sum values (S, ...) slot by slot into (out_size, ...) through a
    contributor table over the S slots (deterministic; see the module
    docstring)."""
    v = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    return v[table].sum(dim=1)


class ElementOp:
    """A global linear operator y = scatter(A_e @ gather(x)).

    A:        (out_k, in_k) shared elemental matrix, or (E, out_k, in_k)
              per-element matrices (a tensor: its device and dtype are
              the apply's).
    in_dofs:  (E, in_k) int64 gather table (a tensor).
    out_dofs: (E, out_k) int64 scatter table (a tensor); entries outside
              [0, out_size) are dropped, as the reference's
              ``mode="drop"``.
    out_size: global output vector length.
    """

    def __init__(self, A, in_dofs, out_dofs, out_size):
        self.A = A
        self.in_dofs = in_dofs
        self.out_dofs = out_dofs
        self.out_size = int(out_size)
        self.table = torch.as_tensor(
            contributor_table(out_dofs.cpu().numpy(), self.out_size),
            device=A.device)

    @property
    def shared(self) -> bool:
        return self.A.dim() == 2

    def __call__(self, x):
        xe = x[self.in_dofs]                              # (E, in_k)
        if self.shared:
            ye = xe @ self.A.T                            # one GEMM
        else:
            ye = torch.bmm(self.A, xe.unsqueeze(-1)).squeeze(-1)
        return scatter_add(ye.reshape(-1), self.table)

    def diagonal(self):
        """Assembled diagonal (only meaningful for square node maps)."""
        if self.shared:
            de = torch.diagonal(self.A).expand(self.in_dofs.shape)
        else:
            de = torch.diagonal(self.A, dim1=1, dim2=2)
        return scatter_add(de.reshape(-1), self.table)


def make_element_op(A, in_dofs, out_dofs, out_size, dtype=torch.float64,
                    device=None):
    """An ElementOp from numpy (or array-like) A and dof tables on
    ``device`` (None: the card)."""
    device = resolve_device(device)

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    return ElementOp(
        A=torch.tensor(np.asarray(A), dtype=dtype, device=device),
        in_dofs=idx(in_dofs), out_dofs=idx(out_dofs), out_size=out_size)
