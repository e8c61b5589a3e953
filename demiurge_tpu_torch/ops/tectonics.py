"""Plate tectonics.

Counterpart of ``demiurge_tpu/ops/tectonics.py``, after the reference
Tectonics filter (src/filter/tectonics/): N plates, each a 4-channel field
in its own plate-local frame (crust height, crust age, ridge/type, spare —
Plate.h:20-25), an accumulated rotation and a constant angular velocity
(Plate.cpp:26-28, 46-48).  One step (Tectonics.cpp:156-272):

  1. rotate every plate by its angular velocity;
  2. fold — resample every plate into the world frame through its rotation
     (NEAREST) and depth-sort them by the age and land rules, marking
     subduction overlaps;
  3. ocean spreading — distance propagation from the plate borders over
     circles of radius 2^i, up then down, 16 taps each; the type channel
     becomes the new-ocean-crust flag;
  4. collision — each plate's velocity field, the convergence at the
     boundaries, and 10 propagation sweeps of the collision distance;
  5. render — ``render_mode='index'`` writes the plate index as the
     reference does; ``'height'`` the crust height plus the collision
     uplift with a distance falloff;
  6. unfold — the world state inverse-rotated into each plate's frame:
     ages advance, crust claimed by other plates goes, and new ridge crust
     appears at divergent boundaries.

The reference runs all of this in XLA, outside any Pallas kernel, so this
port is plain PyTorch on the tensors' device.  Its 4-channel fields are
laid out ``(4, H, W)`` (the reference's ``(H, W, 4)``; ``utils.interop``
converts), so one ``shift`` or gather moves all four channels.  The mutable
``Plate`` list rotates on the host in numpy float32, as the reference
does; the ``PlateStack`` form (``tectonics_step_stacked``,
``tectonic_uplift``) advances its rotations in float32 on the device.
Where the reference divides a Python number by a tensor this port divides
two float32 tensors: torch would take the reciprocal and multiply.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from ..core.fastroll import row_sample_nearest_x
from ..core.grid import Grid, rdiv
from ..core.topology import grid_st, sample_nearest, shift

REF_PI = 3.14159  # the reference's truncated pi of the circle taps


def _channels(*planes) -> torch.Tensor:
    return torch.stack(planes, 0)


def _const4(values, like: torch.Tensor) -> torch.Tensor:
    """A (4, 1, 1) float32 constant on ``like``'s device."""
    return torch.tensor(values, dtype=torch.float32,
                        device=like.device).reshape(4, 1, 1)


# ---------------------------------------------------------------------------
# plates
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Plate:
    """field: (4, H, W) = [crust height, age (< 0 = absent), type, spare];
    rotation (3, 3) and angular_velocity (3,) numpy float32."""

    field: torch.Tensor
    rotation: np.ndarray
    angular_velocity: np.ndarray

    def rotate(self):
        w = self.angular_velocity
        n = np.linalg.norm(w)
        if n > 0:
            self.rotation = self.rotation @ _axis_angle(w / n, n)


def _axis_angle(u, theta) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    ux, uy, uz = u
    omc = 1 - c
    return np.array([
        [c + ux * ux * omc, ux * uy * omc - uz * s, ux * uz * omc + uy * s],
        [uy * ux * omc + uz * s, c + uy * uy * omc, uy * uz * omc - ux * s],
        [uz * ux * omc - uy * s, uz * uy * omc + ux * s, c + uz * uz * omc],
    ], np.float32)


def init_plates(height: torch.Tensor, grid: Grid) -> List[Plate]:
    """The reference's two-plate setup (Tectonics.cpp:15-58): the east
    and the west half of the terrain, angular velocities +-0.01 about
    (-1, 0, 0)."""
    s, _ = grid_st(grid, height.device)
    s = s.expand(grid.shape)
    h = height
    zero, one = torch.zeros_like(h), torch.ones_like(h)
    empty = _channels(zero, -one, zero, zero)
    f0 = torch.where(s > 0.5, _channels(torch.where(h > 0, h, -1.0), one,
                                        zero, zero), empty)
    f1 = torch.where(s < 0.5, _channels(torch.where(h > 0, h, -2.0),
                                        torch.full_like(h, 0.5), zero, zero),
                     empty)
    p0 = Plate(f0, np.eye(3, dtype=np.float32),
               0.01 * np.array([-1.0, 0, 0], np.float32))
    p1 = Plate(f1, np.eye(3, dtype=np.float32),
               -0.01 * np.array([-1.0, 0, 0], np.float32))
    return [p0, p1]


# ---------------------------------------------------------------------------
# frame resampling (tectonicSamplingShader, Tectonics.cpp:61-93)
# ---------------------------------------------------------------------------


def _unit_points(grid: Grid, device):
    """Cartesian unit vectors (x, y, z) of the pixel centers, (H, W)."""
    lam, phi = grid.lam_phi(device)
    x = torch.cos(phi) * torch.cos(lam)
    y = torch.cos(phi) * torch.sin(lam)
    z = torch.sin(phi) * torch.ones_like(lam)
    return x, y, z


def _rotated_st(R: torch.Tensor, grid: Grid):
    """Tex coords of R applied to every pixel center, (H, W) each."""
    x, y, z = _unit_points(grid, R.device)
    rx = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z
    ry = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z
    rz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z
    lam2 = torch.atan2(ry, rx)
    phi2 = torch.asin(torch.clamp(rz, -1.0, 1.0))
    return grid.spheric_to_tex(lam2, phi2)


def _rotated_sample(field4: torch.Tensor, R: torch.Tensor, grid: Grid
                    ) -> torch.Tensor:
    """Sample a (4, H, W) field at the rotation-transformed position of
    every world pixel (NEAREST, like the reference's unfiltered
    textures)."""
    return sample_nearest(field4, *_rotated_st(R, grid))


# ---------------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------------


def _rotation_tensors(plates: List[Plate], device) -> list:
    return [torch.from_numpy(np.asarray(p.rotation, np.float32)).to(device)
            for p in plates]


def fold(plates: List[Plate], grid: Grid) -> torch.Tensor:
    """World state [plate index, height, age, collision] (Tectonics.cpp:
    99-153, 278-293)."""
    device = plates[0].field.device
    return _fold_impl([p.field for p in plates],
                      _rotation_tensors(plates, device), grid)


def _fold_impl(fields, rotations, grid: Grid) -> torch.Tensor:
    world = _const4([0.0, -1.0, -1.0, -1.1e6], fields[0]).expand(
        4, *grid.shape)
    for index, (field, R) in enumerate(zip(fields, rotations), start=1):
        p = _rotated_sample(field, R, grid)
        plate_h, plate_age = p[0], p[1]
        prev_h, prev_age = world[1], world[2]

        overlap = (plate_age >= 0) & (prev_age >= 0)
        fa = torch.where(overlap, plate_h, world[3])
        world = torch.cat([world[:3], fa[None]])

        idx = torch.full_like(plate_h, float(index))
        take_new = (plate_age >= 0) & ~overlap
        world = torch.where(take_new, _channels(idx, plate_h, plate_age, fa),
                            world)

        land_on_ocean = (plate_h > 0) & (prev_h <= 0)
        younger = plate_age < prev_age
        on_top = ((younger & (plate_h <= 0) & (prev_h <= 0))
                  | (~younger & (plate_h > 0) & (prev_h > 0))
                  | land_on_ocean)
        world = torch.where(overlap & on_top,
                            _channels(idx, plate_h, plate_age, prev_h), world)
    return world


def _stretch(grid: Grid, device, numer: float) -> torch.Tensor:
    """numer / cos|phi| per row, (H, 1) float32."""
    return rdiv(numer, torch.cos(torch.abs(grid.row_phi(device))))


def _circle_sample4(field4: torch.Tensor, grid: Grid, radius: float, i: int,
                    n: int = 16, stretch: bool = True) -> torch.Tensor:
    """One of the n circle taps of a (4, H, W) field, with the optional
    1/cos(phi) x stretch (NEAREST through the wrap topology)."""
    ang = 2 * REF_PI * i / n
    dy = math.sin(ang) * radius
    ky = math.floor(0.5 + dy)
    if stretch:
        dx = _stretch(grid, field4.device, math.cos(ang) * radius)
    else:
        dx = torch.full((grid.height, 1), math.cos(ang) * radius,
                        dtype=torch.float32, device=field4.device)
    return row_sample_nearest_x(shift(field4, 0, ky, grid), dx)


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _geodist_const(grid: Grid, dx_pix, dy_pix, device) -> torch.Tensor:
    """geodistance(st, offset(st, (dx, dy))) per row, (H, 1), in x-pixel
    units (Shader.h:345-355).  ``dx_pix`` a number or a per-row (H, 1)
    tensor (stretched), ``dy_pix`` a number; numbers are taken as float32
    where the reference's jnp op takes them."""
    phi1 = grid.row_phi(device)
    dlam = dx_pix * (grid.lam1 - grid.lam0) / grid.width
    dphi = dy_pix * (grid.phi1 - grid.phi0) / grid.height
    phi2 = phi1 + dphi
    if not isinstance(dlam, torch.Tensor):
        dlam = _f32(dlam, device)
    inner = (torch.sin(torch.abs(_f32(dphi, device)) / 2) ** 2
             + torch.cos(phi1) * torch.cos(phi2) * torch.sin(dlam / 2) ** 2)
    ds = 2 * torch.asin(torch.sqrt(torch.clamp(inner, 0.0, 1.0)))
    return ds / (grid.lam1 - grid.lam0) * grid.width


#: circle radii of ocean spreading: 2^i up, then down (Tectonics.cpp:
#: 295-397)
SPREAD_RADII = [2.0 ** i for i in range(5)] + [2.0 ** i
                                               for i in range(5, 0, -1)]


def ocean_spreading(world: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Distance propagation from plate borders (Tectonics.cpp:295-397)."""
    dev = world.device
    world = torch.cat([world[:2], torch.zeros_like(world[2:3]), world[3:]])
    for radius in SPREAD_RADII:
        fc = world
        for i in range(16):
            a = _circle_sample4(world, grid, radius, i)
            ang = 2 * REF_PI * i / 16
            dxp = _stretch(grid, dev, math.cos(ang) * radius)
            dyp = math.sin(ang) * radius
            dist = _geodist_const(grid, dxp, dyp, dev)
            nz = a[2] + dist
            better = ((nz < fc[2]) | (fc[0] == 0)) & (a[0] != 0)
            cand = _channels(a[0], torch.full_like(nz, -1.1), nz,
                             torch.full_like(nz, -1.1e6))
            fc = torch.where(better, cand, fc)
        world = fc
    return torch.cat([world[:2], torch.where(world[2:3] > 0, 1.0, 0.0),
                      world[3:]])


def collision(world: torch.Tensor, plates: List[Plate], grid: Grid
              ) -> torch.Tensor:
    """Convergence + propagation (Tectonics.cpp:399-614).  Returns
    (4, H, W) = [distance, plate index, theta, phi]."""
    return _collision_impl(
        world, [torch.from_numpy(np.asarray(p.angular_velocity, np.float32))
                .to(world.device) for p in plates], grid)


def _collision_impl(world: torch.Tensor, angvels, grid: Grid
                    ) -> torch.Tensor:
    dev = world.device
    # velocity field: the angular velocity of the owning plate (431-442)
    vel = torch.zeros_like(world)
    for index, w3 in enumerate(angvels, start=1):
        w = torch.cat([w3.to(torch.float32),
                       torch.zeros(1, dtype=torch.float32, device=dev)])
        vel = torch.where(world[0] == index, w.reshape(4, 1, 1), vel)

    # convergence at boundaries (445-529)
    lam, phi = grid.lam_phi(dev)
    px, py, pz = (c.expand(grid.shape) for c in _unit_points(grid, dev))

    index_f = world[0]
    sub_h = world[3]
    v0 = vel[:3]

    othercount = torch.zeros_like(index_f)
    otherv = torch.zeros_like(v0)
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            other = shift(index_f, i, j, grid) != index_f
            othercount = othercount + other.to(torch.float32)
            otherv = torch.where(other, shift(v0, i, j, grid), otherv)

    def norm3(v):
        return torch.sqrt(v[0] ** 2 + v[1] ** 2 + v[2] ** 2)

    ov_n = otherv / torch.clamp(norm3(otherv), min=1e-20)
    vdoto = v0[0] * ov_n[0] + v0[1] * ov_n[1] + v0[2] * ov_n[2]
    v = otherv - vdoto * ov_n
    kx = v[1] * pz - v[2] * py
    ky = v[2] * px - v[0] * pz
    kz = v[0] * py - v[1] * px
    magnitude = torch.sqrt(kx * kx + ky * ky + kz * kz)

    theta = torch.acos(torch.clamp(v0[2] / torch.clamp(norm3(v0), min=1e-20),
                                   -1.0, 1.0))
    phi_o = torch.atan2(v0[1], v0[0])

    no_collide = (sub_h <= -1e6) | (sub_h > 0) | (othercount == 0)
    coll = torch.where(no_collide, _const4([1e6, 0.0, 0.0, 0.0], world),
                       _channels(torch.zeros_like(magnitude), magnitude,
                                 theta, phi_o))

    # propagation sweeps (534-613): radius = the sweep number, integer
    # offsets, no x stretch
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    cos_lam, sin_lam = torch.cos(lam), torch.sin(lam)
    for sweep in range(10):
        radius = float(sweep)
        fc = coll
        th, ph = fc[2], fc[3]
        ox = torch.cos(ph) * torch.sin(th)
        oy = torch.sin(ph) * torch.sin(th)
        oz = torch.cos(th)
        # diff2 = -cross(omega, x)
        d2x = -(oy * pz - oz * py)
        d2y = -(oz * px - ox * pz)
        d2z = -(ox * py - oy * px)
        d2n = torch.sqrt(d2x * d2x + d2y * d2y + d2z * d2z)
        minangle = torch.full(grid.shape, 20.0, device=dev)
        for xx in range(16):
            i = int(math.cos(2 * REF_PI * xx / 16) * radius)
            j = int(math.sin(2 * REF_PI * xx / 16) * radius)
            if i == 0 and j == 0:
                continue
            fold_s = shift(coll, i, j, grid)
            n_idx = shift(index_f, i, j, grid)
            # diff = delta_spheric_to_cartesian (543-548):
            # -|dx| * eastish + dy * north
            dn = math.sqrt(i * i + j * j)
            dxn, dyn = i / dn, j / dn
            dX = (-abs(dxn)) * (-cos_phi * sin_lam) + dyn * (
                -sin_phi * cos_lam)
            dY = (-abs(dxn)) * (cos_phi * cos_lam) + dyn * (
                -sin_phi * sin_lam)
            dZ = (dyn * cos_phi).expand(grid.shape)
            dnn = torch.sqrt(dX * dX + dY * dY + dZ * dZ)
            cosang = (d2x * dX + d2y * dY + d2z * dZ) / torch.clamp(
                d2n * dnn, min=1e-20)
            angle = torch.acos(torch.clamp(cosang, -1.0, 1.0))
            dist = _geodist_const(grid, float(i), float(j), dev)
            better = ((n_idx == index_f)
                      & (dist + fold_s[0] < fc[0])
                      & (angle < minangle))
            newfc = torch.cat([(fold_s[0] + dist)[None], fold_s[1:]])
            fc = torch.where(better, newfc, fc)
            minangle = torch.where(better, angle, minangle)
        coll = torch.cat([fc[:1], index_f[None], fc[2:]])
    return coll


def unfold(world: torch.Tensor, plates: List[Plate], grid: Grid
           ) -> List[Plate]:
    """Back to the plate frames (Tectonics.cpp:216-268); sets each
    plate's field."""
    new_fields = _unfold_impl(world, [p.field for p in plates],
                              _rotation_tensors(plates, world.device), grid)
    for plate, nf in zip(plates, new_fields):
        plate.field = nf
    return plates


def _unfold_impl(world: torch.Tensor, fields, rotations, grid: Grid) -> list:
    inv_cos = _stretch(grid, world.device, 1.0)
    gone = _const4([0.0, -1.0, 0.0, 0.0], world)
    out = []
    for index, (field, R) in enumerate(zip(fields, rotations), start=1):
        a = _rotated_sample(world, R.transpose(-1, -2), grid)

        age = field[1]
        fc = torch.cat([field[:1], torch.where(age >= 0, age + 0.01,
                                               age)[None], field[2:]])

        # delete crust claimed by other plates: all 9 samples of the
        # stretched plate-frame neighborhood, inverse-rotated into the
        # world, have another index (a[st] = world[Rinv st], so sampling
        # the offset pixel's 'a' is shifting 'a' itself)
        different = torch.ones(grid.shape, dtype=torch.bool,
                               device=world.device)
        for i in (-1, 0, 1):
            for j in (-1, 0, 1):
                tap_idx = row_sample_nearest_x(shift(a[0], 0, j, grid),
                                               i * inv_cos)
                different = different & (tap_idx != index)

        delete = different & ~((a[1] <= 0) & (fc[0] > 0))
        fc = torch.where(delete, gone, fc)

        # new ridge crust
        new = (fc[1] < 0) & (a[0] == index) & (torch.abs(a[2] - 1.0) < 0.01)
        fc = torch.where(new, _const4([-float(index), 1.0, 0.0, 0.0], world),
                         fc)
        out.append(fc)
    return out


@dataclasses.dataclass(frozen=True)
class TectonicsConfig:
    steps: int = 70                   # Tectonics.cpp:157
    render_mode: str = "height"       # 'index' = exact reference output
    uplift_scale: float = 1.0
    uplift_range: float = 100.0       # px distance falloff for intent uplift


def _uplift(coll: torch.Tensor, cfg: TectonicsConfig) -> torch.Tensor:
    """The collision uplift with its distance falloff: the propagation
    sweeps overwrite the magnitude channel with the plate index
    (Tectonics.cpp:590), so it decays with the propagated distance only."""
    dist = coll[0]
    return torch.where(dist < 1e6, torch.clamp(1.0 - dist / cfg.uplift_range,
                                               min=0.0), 0.0)


def render_terrain(world: torch.Tensor, coll: torch.Tensor, grid: Grid,
                   cfg: TectonicsConfig) -> torch.Tensor:
    """Terrain output (Tectonics.cpp:186-210): 'index' writes the
    collision result's plate-index channel, as the reference does;
    'height' the world crust height plus the collision-driven uplift."""
    if cfg.render_mode == "index":
        return coll[1]
    return world[1] + cfg.uplift_scale * _uplift(coll, cfg)


def tectonics_step(plates: List[Plate], grid: Grid,
                   cfg: TectonicsConfig = TectonicsConfig()):
    """One full tectonics step; returns (plates, terrain)."""
    for p in plates:
        p.rotate()
    world = fold(plates, grid)
    world = ocean_spreading(world, grid)
    coll = collision(world, plates, grid)
    terrain = render_terrain(world, coll, grid, cfg)
    plates = unfold(world, plates, grid)
    return plates, terrain


def run_tectonics(height: torch.Tensor, grid: Grid,
                  cfg: TectonicsConfig = TectonicsConfig(),
                  plates: List[Plate] = None):
    """The full run of ``cfg.steps`` steps (Tectonics.cpp:156-272)."""
    if plates is None:
        plates = init_plates(height, grid)
    terrain = height
    for _ in range(cfg.steps):
        plates, terrain = tectonics_step(plates, grid, cfg)
    return plates, terrain


# ---------------------------------------------------------------------------
# the stacked form: every plate in one tensor, rotations on the device
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlateStack:
    """Every plate at once: ``fields`` (P, 4, H, W) in plate-local frames,
    ``rotations`` (P, 3, 3) accumulated (advanced in-step on the device)
    and ``angvel`` (P, 3) constant angular velocities, all float32."""

    fields: torch.Tensor
    rotations: torch.Tensor
    angvel: torch.Tensor

    @property
    def n_plates(self) -> int:
        return self.fields.shape[0]


def plate_stack(plates: List[Plate]) -> PlateStack:
    dev = plates[0].field.device
    return PlateStack(
        fields=torch.stack([p.field for p in plates]),
        rotations=torch.stack(_rotation_tensors(plates, dev)),
        angvel=torch.stack([torch.from_numpy(
            np.asarray(p.angular_velocity, np.float32)).to(dev)
            for p in plates]))


def init_plate_stack(height: torch.Tensor, grid: Grid) -> PlateStack:
    return plate_stack(init_plates(height, grid))


def _axis_angle_t(w: torch.Tensor) -> torch.Tensor:
    """(3,) angular velocity -> the rotation by |w| about w/|w|, float32 on
    w's device (the identity for |w| = 0)."""
    n = torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
    safe = torch.clamp(n, min=1e-20)
    ux, uy, uz = w[0] / safe, w[1] / safe, w[2] / safe
    c, s = torch.cos(n), torch.sin(n)
    omc = 1 - c
    R = torch.stack([
        torch.stack([c + ux * ux * omc, ux * uy * omc - uz * s,
                     ux * uz * omc + uy * s]),
        torch.stack([uy * ux * omc + uz * s, c + uy * uy * omc,
                     uy * uz * omc - ux * s]),
        torch.stack([uz * ux * omc - uy * s, uz * uy * omc + ux * s,
                     c + uz * uz * omc]),
    ])
    return torch.where(n > 0, R, torch.eye(3, dtype=w.dtype, device=w.device))


def _advance(stack: PlateStack, grid: Grid):
    """Rotate the stack one step, fold, spread and collide: (rotations,
    world, coll, per-plate lists)."""
    P = stack.n_plates
    rot = stack.rotations @ torch.stack([_axis_angle_t(stack.angvel[i])
                                         for i in range(P)])
    fields = [stack.fields[i] for i in range(P)]
    rotations = [rot[i] for i in range(P)]
    world = _fold_impl(fields, rotations, grid)
    world = ocean_spreading(world, grid)
    coll = _collision_impl(world, [stack.angvel[i] for i in range(P)], grid)
    return rot, world, coll, fields, rotations


def tectonics_step_stacked(stack: PlateStack, grid: Grid,
                           cfg: TectonicsConfig = TectonicsConfig()):
    """One full tectonics step of the stack, the same passes as
    ``tectonics_step``.  Returns (stack, terrain)."""
    rot, world, coll, fields, rotations = _advance(stack, grid)
    terrain = render_terrain(world, coll, grid, cfg)
    new_fields = _unfold_impl(world, fields, rotations, grid)
    return PlateStack(fields=torch.stack(new_fields), rotations=rot,
                      angvel=stack.angvel), terrain


def tectonic_uplift(stack: PlateStack, grid: Grid,
                    cfg: TectonicsConfig = TectonicsConfig()):
    """The collision-driven orogeny uplift for live erosion forcing (the
    distance-falloff term of ``render_terrain``'s 'height' mode), scaled to
    the stream-power convention U = h/50 (cpufilter.cpp:42-64).  Advances
    the stack one step; returns (stack, uplift)."""
    rot, world, coll, fields, rotations = _advance(stack, grid)
    uplift = _uplift(coll, cfg)
    new_fields = _unfold_impl(world, fields, rotations, grid)
    return (PlateStack(fields=torch.stack(new_fields), rotations=rot,
                       angvel=stack.angvel),
            cfg.uplift_scale * uplift / 50.0)
