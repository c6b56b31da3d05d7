"""One 64th of a Nyx cosmology snapshot, made on the device from a seed.

Six fields on a cube of ``cells`` cells cut into ``max_grid_size`` boxes
at one level, two snapshots.  From one seeded white-noise field: the dark
matter and the baryon density are lognormal over a Gaussian random field
with a power-law spectrum (the baryons' cut off above ``jeans_k``); the
temperature is a power law of the baryon density; the velocities are the
linear-theory gradient of the same modes.  The second snapshot grows the
same modes and mixes in a little fresh noise.

The fields are one fixed realization (``realization_seed``); the run's
seed draws a periodic offset of whole boxes.  So every seed compresses the
same boxes in another order and under other names, and the work and the
archive's size do not change with the seed.
"""

from __future__ import annotations

import torch

from wtbench.datagen import Dataset, Snapshot, as_host


def _standard(x: torch.Tensor) -> torch.Tensor:
    x = x - x.mean()
    return x / x.std()


def _fields(white: torch.Tensor, a: dict, growth: float) -> list:
    n = white.shape[0]
    dev = white.device
    wk = torch.fft.rfftn(white)
    kx = torch.fft.fftfreq(n, d=1.0 / n, device=dev)
    kz = torch.fft.rfftfreq(n, d=1.0 / n, device=dev)
    k2 = kx[:, None, None] ** 2 + kx[None, :, None] ** 2 + kz[None, None] ** 2
    k2[0, 0, 0] = 1.0
    amp = k2 ** (a["spectral_index"] / 4.0)
    amp[0, 0, 0] = 0.0
    modes = wk * amp
    del wk
    shape = (n, n, n)
    d_dm = _standard(torch.fft.irfftn(modes, s=shape))
    kj = a["jeans_k_over_nyquist"] * (n // 2)
    d_b = _standard(torch.fft.irfftn(modes * torch.exp(-k2 / kj ** 2), s=shape))
    s_dm, s_b = a["sigma_ln_dm"] * growth, a["sigma_ln_baryon"] * growth
    rho_dm = a["mean_dm"] * torch.exp(s_dm * d_dm - s_dm ** 2 / 2)
    rho_b = a["mean_baryon"] * torch.exp(s_b * d_b - s_b ** 2 / 2)
    temp = a["t0"] * (rho_b / a["mean_baryon"]) ** a["gamma_minus_1"]
    out = [rho_b, rho_dm, temp]
    for k in (kx[:, None, None], kx[None, :, None], kz[None, None]):
        v = torch.fft.irfftn(modes * (1j * k / k2), s=shape)
        out.append(a["sigma_v"] * growth * _standard(v))
    return out


def generate(cfg: dict, seed: int, device) -> Dataset:
    a = cfg["assumed"]
    n, b = int(cfg["cells"]), int(cfg["max_grid_size"])
    nb = n // b
    shift = (torch.randint(0, nb, (3,), generator=torch.Generator().manual_seed(
        seed)) * b).tolist()
    g = torch.Generator(device=device).manual_seed(int(a["realization_seed"]))
    white = torch.randn((n, n, n), generator=g, device=device)
    snaps = []
    for s in cfg["snapshots"]:
        if snaps:
            fresh = torch.randn((n, n, n), generator=g, device=device)
            mix = a["fresh_noise"]
            white = (1 - mix ** 2) ** 0.5 * white + mix * fresh
            del fresh
        f = torch.roll(torch.stack(_fields(white, a, float(s["growth"]))),
                       shift, dims=(1, 2, 3)).float()
        # [C, X, Y, Z] -> boxes [nb^3, C, b, b, b], x-major box order
        boxes = f.reshape(len(f), nb, b, nb, b, nb, b).permute(
            1, 3, 5, 0, 2, 4, 6).reshape(nb ** 3, len(f), b, b, b)
        host = as_host(boxes)
        del f, boxes
        locs = [(i * b, j * b, k * b) for i in range(nb) for j in range(nb)
                for k in range(nb)]
        snaps.append(Snapshot(name=s["name"], time=float(s["time"]),
                              step=int(s["step"]), boxes=[list(host)],
                              locations=[locs]))
    return Dataset(components=list(cfg["components"]), base_dims=(n, n, n),
                   ref_ratio=2, prob_lo=tuple(cfg["prob_lo"]),
                   prob_hi=tuple(cfg["prob_hi"]), snapshots=snaps)
