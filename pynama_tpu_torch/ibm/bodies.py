"""Lagrangian immersed bodies: generators, kinematics, force integration.

A copy of pynama_tpu/ibm/bodies.py (numpy only; the port imports nothing
of the reference package). A body is its point coordinates (L, 2), its
segment length dl and its prescribed velocity: everything the
delta-function coupling needs. Coordinates, kinematics and split_forces
are the reference's bit for bit (tests/test_torch_ibm_coupling.py).
"""

from dataclasses import dataclass, field
from math import ceil, pi, sqrt
from typing import List, Optional

import numpy as np


@dataclass
class ImmersedBody:
    center: np.ndarray
    is_moving: bool = False
    vel_ref: float = 1.0

    local_coords: np.ndarray = None  # (L, 2) body-frame coordinates
    dl: float = None

    def generate(self, dh: float):
        raise NotImplementedError

    @property
    def n_nodes(self):
        return len(self.local_coords)

    def char_length(self):
        return 1.0

    # -- kinematics -------------------------------------------------------
    def state_at(self, t: float):
        """(displacement (2,), velocity (2,)) of the body frame at time t.

        Prescribed vertical oscillation for moving bodies: A=0.3, f=5,
        Te = f/U_ref.
        """
        if not self.is_moving:
            return np.asarray(self.center, float), np.zeros(2)
        A, f = 0.3, 5.0
        Te = f / self.vel_ref
        disp = np.asarray(self.center, float) + np.array(
            [0.0, A * np.sin(2 * pi * t / Te)]
        )
        vel = np.array([0.0, 2 * pi * A * np.cos(2 * pi * t / Te) / Te])
        return disp, vel

    def coords_at(self, t: float):
        disp, _ = self.state_at(t)
        return self.local_coords + disp[None, :]

    def velocity_at(self, t: float):
        """(L, 2) prescribed velocity of every body point."""
        _, v = self.state_at(t)
        return np.broadcast_to(v, (self.n_nodes, 2)).copy()


@dataclass
class Circle(ImmersedBody):
    radius: float = 0.5

    def generate(self, dh: float):
        """Parity: Circle.generateBody (immersed_body.py:371-389)."""
        r = self.radius
        total = 2 * pi * r
        points = ceil(total / dh)
        start_ang = pi / 1000
        angles = np.linspace(0, 2 * pi, points, endpoint=False) + start_ang
        self.local_coords = np.stack(
            [r * np.cos(angles), r * np.sin(angles)], axis=1
        )
        self.dl = total / points
        return self

    def char_length(self):
        return 2 * self.radius


@dataclass
class Line(ImmersedBody):
    length: float = 2.0

    def generate(self, dh: float):
        """Parity: Line.generateBody (immersed_body.py:294-307)."""
        div = ceil(self.length / dh)
        xs = np.linspace(0, self.length, div)
        self.local_coords = np.stack([xs, np.zeros(div)], axis=1)
        self.dl = dh
        return self


@dataclass
class OpenBox(ImmersedBody):
    half: float = 1.0

    def generate(self, dh: float):
        """Diamond-oriented open box (parity: immersed_body.py:316-345)."""
        L = self.half
        div = ceil(sqrt(2.0) / dh)
        verts = [(0, L), (-L, 0), (0, -L), (L, 0), (0, L)]
        xs, ys = [], []
        for (x1, y1), (x2, y2) in zip(verts[:-1], verts[1:]):
            xs.append(np.linspace(x1, x2, div, endpoint=False))
            ys.append(np.linspace(y1, y2, div, endpoint=False))
        self.local_coords = np.stack(
            [np.concatenate(xs), np.concatenate(ys)], axis=1
        )
        self.dl = dh
        return self

    def velocity_at(self, t: float):
        """Lid-driven-cavity style: only the upper-right faces move
        (parity: OpenBox.updateVelocity, immersed_body.py:347-358)."""
        v = np.zeros((self.n_nodes, 2))
        sel = (self.local_coords[:, 0] >= 0) & (self.local_coords[:, 1] >= 0)
        v[sel, 0] = self.vel_ref / sqrt(2.0)
        v[sel, 1] = -self.vel_ref / sqrt(2.0)
        return v


class BodiesContainer:
    """Multiple bodies concatenated into one Lagrangian point set.

    Parity: BodiesContainer (immersed_body.py:8-132).
    """

    TYPES = {"circle": Circle, "line": Line, "box": OpenBox}

    def __init__(self, body_configs):
        self.bodies: List[ImmersedBody] = []
        for cfg in body_configs:
            kind = cfg["type"]
            kwargs = {"center": np.asarray(cfg.get("center", [0, 0]), float)}
            if kind == "circle":
                kwargs["radius"] = float(cfg.get("radius", 0.5))
            body = self.TYPES[kind](**kwargs)
            if cfg.get("vel") == "dynamic":
                body.is_moving = True
            self.bodies.append(body)

    def create(self, dh: float):
        for b in self.bodies:
            b.generate(dh)
        return self

    def set_vel_ref(self, u):
        for b in self.bodies:
            b.vel_ref = float(u)

    @property
    def n_nodes(self):
        return sum(b.n_nodes for b in self.bodies)

    @property
    def dl(self):
        return self.bodies[0].dl

    @property
    def is_moving(self):
        return any(b.is_moving for b in self.bodies)

    def coords_at(self, t: float):
        return np.concatenate([b.coords_at(t) for b in self.bodies])

    def velocity_at(self, t: float):
        return np.concatenate([b.velocity_at(t) for b in self.bodies])

    def split_forces(self, q, scale):
        """Per-body (fx, fy) from the virtual flux vector q (L, 2).

        Parity: BodiesContainer.computeForce (immersed_body.py:86-97).
        """
        out = []
        off = 0
        for b in self.bodies:
            qq = q[off : off + b.n_nodes]
            out.append((float(qq[:, 0].sum() / scale), float(qq[:, 1].sum() / scale)))
            off += b.n_nodes
        return out
