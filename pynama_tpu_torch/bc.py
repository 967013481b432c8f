"""Wall boundary-condition metadata for box domains.

TPU-native equivalent of upstream Pynama src/common/nswalls.py (NoSlipWalls
/ Wall / Vertex): declarative per-side wall model with axis-aligned normals,
wall velocities, and static/moving tangential-dof bookkeeping. The linked
vertex chains of the reference reduce to the face-name -> normal-axis map
of the structured mesh.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from pynama_tpu_torch.mesh.structured import FACE_NORMAL_AXIS_2D, FACE_NORMAL_AXIS_3D


@dataclass
class Wall:
    name: str
    normal_axis: int
    dim: int
    velocity: Optional[np.ndarray] = None  # full dim-vector or None (static)

    @property
    def tangential_dofs(self) -> List[int]:
        return [d for d in range(self.dim) if d != self.normal_axis]

    @property
    def moving_dofs(self) -> List[int]:
        """Tangential dofs with prescribed nonzero velocity.

        Parity: Wall.setWallVelocity (nswalls.py:201-215).
        """
        if self.velocity is None:
            return []
        return [d for d in self.tangential_dofs if self.velocity[d] != 0]

    @property
    def static_dofs(self) -> List[int]:
        """Tangential dofs pinned to zero (no-slip, not moving)."""
        moving = set(self.moving_dofs)
        return [d for d in self.tangential_dofs if d not in moving]


class NoSlipWalls:
    """All box sides as no-slip walls, minus an exclude list.

    Parity: NoSlipWalls (nswalls.py:5-112).
    """

    def __init__(self, dim: int, exclude: Sequence[str] = ()):
        self.dim = dim
        normal_map = FACE_NORMAL_AXIS_2D if dim == 2 else FACE_NORMAL_AXIS_3D
        sides = (
            ["left", "right", "up", "down"]
            if dim == 2
            else ["left", "right", "up", "down", "back", "front"]
        )
        self.walls: Dict[str, Wall] = {
            s: Wall(name=s, normal_axis=normal_map[s], dim=dim)
            for s in sides
            if s not in exclude
        }

    def set_wall_velocity(self, name: str, vel):
        vel = np.asarray(vel, dtype=np.float64)
        if len(vel) != self.dim:
            raise ValueError("wall velocity must have dim components")
        self.walls[name].velocity = vel

    def names(self):
        return list(self.walls.keys())

    def walls_with_velocity(self):
        return [w for w in self.walls.values() if w.moving_dofs]

    def static_walls(self):
        return [w for w in self.walls.values() if not w.moving_dofs]

    def __getitem__(self, name):
        return self.walls[name]

    def __len__(self):
        return len(self.walls)
