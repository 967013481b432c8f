"""Analytic verification fields, vectorized over node coordinates.

Port of pynama_tpu/cases/analytic_fields.py (the reference's
taylorGreen*/senoidal*/flatplate* static methods). Every function takes
coords (N, dim) as a tensor, the kinematic viscosity nu and the time t
as floats, and returns tensors on coords' device and dtype: velocity
(N, dim), vorticity (N, dim_w), convective/diffusive terms (N, dim_w).
"""

import math

import torch

TWO_PI = 2.0 * math.pi
PI = math.pi


# ----------------------------------------------------------------------
# Taylor-Green 2D (Lx = Ly = 1, Uref = 1)
# ----------------------------------------------------------------------
def taylor_green_vel_2d(coords, nu, t):
    x = TWO_PI * coords[:, 0]
    y = TWO_PI * coords[:, 1]
    expo = math.exp(-8.0 * PI**2 * nu * t)
    return torch.stack([torch.cos(x) * torch.sin(y) * expo,
                        -torch.sin(x) * torch.cos(y) * expo], dim=1)


def taylor_green_vort_2d(coords, nu, t):
    x = TWO_PI * coords[:, 0]
    y = TWO_PI * coords[:, 1]
    expo = math.exp(-8.0 * PI**2 * nu * t)
    return (-4.0 * PI * torch.cos(x) * torch.cos(y) * expo)[:, None]


# ----------------------------------------------------------------------
# Taylor-Green 3D (Lx = Ly = Lz = 1)
# ----------------------------------------------------------------------
def _xyz(coords):
    return (TWO_PI * coords[:, i] for i in range(3))


def taylor_green_vel_3d(coords, nu, t):
    x, y, z = _xyz(coords)
    expo = math.exp(-12.0 * PI**2 * nu * t)
    return torch.stack([
        torch.cos(x) * torch.sin(y) * torch.sin(z) * expo,
        torch.sin(x) * torch.cos(y) * torch.sin(z) * expo,
        -2.0 * torch.sin(x) * torch.sin(y) * torch.cos(z) * expo,
    ], dim=1)


def taylor_green_vort_3d(coords, nu, t):
    x, y, z = _xyz(coords)
    expo = math.exp(-12.0 * PI**2 * nu * t)
    return torch.stack([
        -2.0 * PI * 3.0 * torch.sin(x) * torch.cos(y) * torch.cos(z) * expo,
        2.0 * PI * 3.0 * torch.cos(x) * torch.sin(y) * torch.cos(z) * expo,
        torch.zeros_like(x),
    ], dim=1)


def taylor_green_conv_3d(coords, nu, t):
    x, y, z = _xyz(coords)
    expo = math.exp(-12.0 * PI**2 * nu * t)
    f = (TWO_PI * expo) ** 2
    return torch.stack([
        -2.0 * 3.0 * f * torch.sin(y) * torch.cos(y) * torch.sin(z)
        * torch.cos(z),
        2.0 * 3.0 * f * torch.sin(x) * torch.cos(x) * torch.sin(z)
        * torch.cos(z),
        torch.zeros_like(x),
    ], dim=1)


def taylor_green_diff_3d(coords, nu, t):
    x, y, z = _xyz(coords)
    expo = nu * math.exp(-12.0 * PI**2 * nu * t)
    f = TWO_PI**3 * expo
    return torch.stack([
        f * torch.sin(x) * torch.cos(y) * torch.cos(z) * (2.0 * 3.0 + 3.0),
        -f * torch.cos(x) * torch.sin(y) * torch.cos(z) * (2.0 * 3.0 + 3.0),
        torch.zeros_like(x),
    ], dim=1)


# ----------------------------------------------------------------------
# Taylor-Green 2D-in-3D
# ----------------------------------------------------------------------
def taylor_green_vel_2d3d(coords, nu, t):
    x = TWO_PI * coords[:, 0]
    y = TWO_PI * coords[:, 1]
    expo = math.exp(-8.0 * PI**2 * nu * t)
    return torch.stack([torch.cos(x) * torch.sin(y) * expo,
                        -torch.sin(x) * torch.cos(y) * expo,
                        torch.zeros_like(x)], dim=1)


def taylor_green_vort_2d3d(coords, nu, t):
    x = TWO_PI * coords[:, 0]
    y = TWO_PI * coords[:, 1]
    expo = math.exp(-8.0 * PI**2 * nu * t)
    return torch.stack([torch.zeros_like(x), torch.zeros_like(x),
                        -4.0 * PI * torch.cos(x) * torch.cos(y) * expo],
                       dim=1)


# ----------------------------------------------------------------------
# Senoidal 2D (steady; Wref_x = 4, Wref_y = 2)
# ----------------------------------------------------------------------
_WX = 4.0
_WY = 2.0


def senoidal_vel_2d(coords, nu, t):
    xa = _WY * PI * coords[:, 1]
    ya = _WX * PI * coords[:, 0]
    return torch.stack([torch.sin(xa), torch.sin(ya)], dim=1)


def senoidal_vort_2d(coords, nu, t):
    xa = _WY * PI * coords[:, 1]
    ya = _WX * PI * coords[:, 0]
    return (_WX * PI * torch.cos(ya) - _WY * PI * torch.cos(xa))[:, None]


def senoidal_conv_2d(coords, nu, t):
    xa = _WY * PI * coords[:, 1]
    ya = _WX * PI * coords[:, 0]
    return (((_WY * PI) ** 2 - (_WX * PI) ** 2) * torch.sin(xa)
            * torch.sin(ya))[:, None]


def senoidal_diff_2d(coords, nu, t):
    xa = _WY * PI * coords[:, 1]
    ya = _WX * PI * coords[:, 0]
    return (-((_WX * PI) ** 3) * torch.cos(ya)
            + (_WY * PI) ** 3 * torch.cos(xa))[:, None]


# ----------------------------------------------------------------------
# Flat plate (Stokes' first problem; erf profile)
# ----------------------------------------------------------------------
def flat_plate_vel(coords, nu, t):
    tau = math.sqrt(4.0 * nu * t)
    vx = torch.special.erf(coords[:, 1] / tau)
    return torch.stack([vx, torch.ones_like(vx)], dim=1)


def flat_plate_vort(coords, nu, t):
    tau = math.sqrt(4.0 * nu * t)
    return ((-2.0 / (tau * math.sqrt(PI)))
            * torch.exp(-((coords[:, 1] / tau) ** 2)))[:, None]


def flat_plate_conv(coords, nu, t):
    tau = math.sqrt(4.0 * nu * t)
    alpha = 4.0 * coords[:, 1] / (math.sqrt(PI) * tau**3)
    return (alpha * torch.exp(-((coords[:, 1] / tau) ** 2)))[:, None]


def flat_plate_diff(coords, nu, t):
    tau = math.sqrt(4.0 * nu * t)
    alpha = 4.0 / (math.sqrt(PI) * tau**3)
    beta = 1.0 - 2.0 * coords[:, 1] ** 2 / tau**2
    return (nu * alpha * beta
            * torch.exp(-((coords[:, 1] / tau) ** 2)))[:, None]


CASES_2D = {
    "taylor-green": (taylor_green_vel_2d, taylor_green_vort_2d, None, None),
    "senoidal": (senoidal_vel_2d, senoidal_vort_2d, senoidal_conv_2d,
                 senoidal_diff_2d),
    "flat-plate": (flat_plate_vel, flat_plate_vort, flat_plate_conv,
                   flat_plate_diff),
}
CASES_3D = {
    "taylor-green": (taylor_green_vel_3d, taylor_green_vort_3d,
                     taylor_green_conv_3d, taylor_green_diff_3d),
    "taylor-green2d-3d": (taylor_green_vel_2d3d, taylor_green_vort_2d3d,
                          None, None),
}
