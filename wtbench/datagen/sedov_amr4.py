"""A Sedov blast wave on four AMR levels, after Castro's
``Exec/hydro_tests/Sedov``, made on the device from a seed.

Level 0 covers the unit cube with ``max_grid_size`` boxes.  Each finer
level tags the ``blocking_factor``-cell blocks that lie within ``band``
of its own cells of the unperturbed shock sphere, and inside each
``max_grid_size`` tile the tagged blocks' bounding box is one box, so
boxes are 8 to 32 cells a side in steps of 8 and not cubes.  The layout
depends on the configuration alone, not on the seed.

The fields follow an approximate self-similar profile behind a shock of
radius R(t) = xi0 (E t^2 / rho)^(1/5): density ``rho2 xi^7.5``, pressure
``p2 (p_c + (1 - p_c) xi^8)``, radial velocity ``u2 xi``, temperature
``p / max(rho, rho_floor)``, with ``xi = r / R(n)``.  A few quadrupoles
perturb the shock radius and a few plane waves the post-shock flow, one
fixed realization (``realization_seed``); outside the shock the gas is at
rest and exactly uniform.  The run's seed orders the boxes of each level,
so every seed compresses the same boxes in another order.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from wtbench.datagen import Dataset, Snapshot, as_host


def shock_radius(cfg: dict, t: float) -> float:
    a = cfg["assumed"]
    return a["xi0"] * (cfg["exp_energy"] * t * t
                       / cfg["dens_ambient"]) ** 0.2


def layout(cfg: dict, radius: float) -> list:
    """[level] -> [(lo, dims)] of the boxes around a shock of ``radius``."""
    base, tile = int(cfg["base_cells"]), int(cfg["max_grid_size"])
    blk, band = int(cfg["blocking_factor"]), float(cfg["band_cells"])
    levels = []
    for lev in range(int(cfg["levels"])):
        n = base * int(cfg["ref_ratio"]) ** lev
        if lev == 0:
            levels.append([((i, j, k), (tile, tile, tile)) for i, j, k in
                           itertools.product(range(0, n, tile), repeat=3)])
            continue
        dx, nb, tb = 1.0 / n, n // blk, tile // blk
        c = (np.arange(nb) * blk + blk / 2) * dx - 0.5
        r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2
                    + c[None, None] ** 2)
        tag = np.abs(r - radius) <= (band + math.sqrt(3) * blk / 2) * dx
        boxes = []
        for ti, tj, tk in itertools.product(range(nb // tb), repeat=3):
            sub = tag[ti * tb:(ti + 1) * tb, tj * tb:(tj + 1) * tb,
                      tk * tb:(tk + 1) * tb]
            if not sub.any():
                continue
            idx = np.argwhere(sub)
            lo, hi = idx.min(0), idx.max(0) + 1
            boxes.append((tuple(int((t * tb + l) * blk)
                                for t, l in zip((ti, tj, tk), lo)),
                          tuple(int((h - l) * blk) for l, h in zip(lo, hi))))
        levels.append(boxes)
    return levels


def _box_fields(cfg, lo, dims, n, t, radius, pert, dev) -> torch.Tensor:
    a = cfg["assumed"]
    g = a["gamma"]
    dx = 1.0 / n
    ax = [((torch.arange(d, device=dev, dtype=torch.float64) + lo_d + 0.5)
           * dx - 0.5) for lo_d, d in zip(lo, dims)]
    x, y, z = torch.meshgrid(*ax, indexing="ij")
    r = torch.sqrt(x * x + y * y + z * z)
    rs = torch.clamp(r, min=1e-12)
    nx, ny, nz = x / rs, y / rs, z / rs
    u_dirs, amps, kvec, phase = pert
    mod = torch.zeros_like(r)
    for u, w in zip(u_dirs, amps):
        cos = nx * u[0] + ny * u[1] + nz * u[2]
        mod = mod + w * 0.5 * (3 * cos * cos - 1)
    xi = r / (radius * (1 + a["radius_perturbation"] * mod))
    wave = torch.zeros_like(r)
    for k, ph in zip(kvec, phase):
        wave = wave + torch.sin(k[0] * x + k[1] * y + k[2] * z + ph)
    wave = 1 + a["flow_perturbation"] * wave / math.sqrt(len(kvec))
    rho1, p1 = cfg["dens_ambient"], cfg["p_ambient"]
    rdot = 0.4 * radius / t
    rho2 = rho1 * (g + 1) / (g - 1)
    u2 = 2 * rdot / (g + 1)
    p2 = 2 * rho1 * rdot * rdot / (g + 1)
    inside = xi < 1
    xi_c = torch.clamp(xi, max=1.0)
    rho = torch.where(inside, rho2 * xi_c ** 7.5 * wave,
                      torch.full_like(r, rho1))
    pc = a["central_pressure_ratio"]
    p = torch.where(inside, p2 * (pc + (1 - pc) * xi_c ** 8) * wave,
                    torch.full_like(r, p1))
    u = torch.where(inside, u2 * xi_c * wave, torch.zeros_like(r))
    temp = p / torch.clamp(rho, min=a["dens_floor_ratio"] * rho2)
    return torch.stack([rho, temp, p, u * nx]).float()


def generate(cfg: dict, seed: int, device) -> Dataset:
    a = cfg["assumed"]
    gen = torch.Generator(device="cpu").manual_seed(int(a["realization_seed"]))
    order = torch.Generator(device="cpu").manual_seed(seed)
    n_modes, n_waves = int(a["radius_modes"]), int(a["flow_waves"])
    u_dirs = torch.randn((n_modes, 3), generator=gen, dtype=torch.float64)
    u_dirs = (u_dirs / u_dirs.norm(dim=1, keepdim=True)).tolist()
    amps = torch.randn(n_modes, generator=gen, dtype=torch.float64).tolist()
    kdir = torch.randn((n_waves, 3), generator=gen, dtype=torch.float64)
    kvec = (kdir / kdir.norm(dim=1, keepdim=True)
            * 2 * math.pi * a["flow_wavenumber"]).tolist()
    phase = (torch.rand(n_waves, generator=gen, dtype=torch.float64)
             * 2 * math.pi).tolist()
    pert = (u_dirs, amps, kvec, phase)
    base, rr = int(cfg["base_cells"]), int(cfg["ref_ratio"])
    snaps = []
    for s in cfg["snapshots"]:
        t = float(s["time"])
        radius = shock_radius(cfg, t)
        levels, locs = [], []
        for lev, boxes in enumerate(layout(cfg, radius)):
            n = base * rr ** lev
            boxes = [boxes[i] for i in torch.randperm(len(boxes),
                                                      generator=order)]
            levels.append([as_host(_box_fields(cfg, lo, dims, n, t, radius,
                                               pert, device))
                           for lo, dims in boxes])
            locs.append([lo for lo, _ in boxes])
        snaps.append(Snapshot(name=s["name"], time=t, step=int(s["step"]),
                              boxes=levels, locations=locs))
    return Dataset(components=list(cfg["components"]),
                   base_dims=(base, base, base), ref_ratio=rr,
                   prob_lo=(0.0, 0.0, 0.0), prob_hi=(1.0, 1.0, 1.0),
                   snapshots=snaps)
