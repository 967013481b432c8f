"""Distributed runs on torch.distributed (gloo ranks on the CPU, NCCL on
the card): slabs and pencils of a box mesh (sharded_problem.py), and the
cells of any mesh split into chunks over replicated state
(``ShardedUnstructuredProblem``)."""

from pynama_tpu_torch.parallel.unstructured import ShardedUnstructuredProblem

__all__ = ["ShardedUnstructuredProblem"]
