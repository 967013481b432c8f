from pynama_tpu_torch.mesh.structured import BoxMesh

__all__ = ["BoxMesh"]
