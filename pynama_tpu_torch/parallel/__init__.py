"""Distributed runs over slabs and pencils of a box mesh
(torch.distributed: gloo ranks on the CPU, NCCL on the card)."""
