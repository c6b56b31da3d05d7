"""A plain NumPy writer of AMReX plotfiles, frozen with the benchmark.

It writes what ``amrex::WriteMultiLevelPlotfile`` writes for a one-rank
run: the text ``Header`` (HyperCLaw-V1.1), and per level a VisMF
``Cell_H`` and one ``Cell_D_00000`` of little-endian IEEE doubles, each
box's FAB with its header line and its components outermost, x fastest.
The benchmark's inputs are written with it, so that the program under test
reads files it did not write.
"""

from __future__ import annotations

import os

import numpy as np

_F64_DESC = "((8, (64 11 52 0 1 12 0 1023)),(8, (8 7 6 5 4 3 2 1)))"


def _g17(x: float) -> str:
    return "%.17g" % float(x)


def _box(lo, dims) -> str:
    hi = [int(l) + int(d) - 1 for l, d in zip(lo, dims)]
    return ("((" + ",".join(str(int(v)) for v in lo) + ") ("
            + ",".join(str(v) for v in hi) + ") (0,0,0))")


def _write_level(lvl_dir: str, boxes, locations, ncomp: int) -> int:
    os.makedirs(lvl_dir, exist_ok=True)
    offsets, mins, maxs = [], [], []
    written = 0
    with open(os.path.join(lvl_dir, "Cell_D_00000"), "wb") as f:
        for arr, lo in zip(boxes, locations):
            offsets.append(f.tell())
            head = f"FAB {_F64_DESC}{_box(lo, arr.shape[1:])} {ncomp}\n"
            f.write(head.encode())
            fab = np.ascontiguousarray(arr.transpose(0, 3, 2, 1),
                                       dtype="<f8")
            f.write(fab.data)
            written += len(head) + fab.nbytes
            flat = arr.reshape(ncomp, -1)
            mins.append(flat.min(axis=1).astype(np.float64))
            maxs.append(flat.max(axis=1).astype(np.float64))
    lines = ["1", "1", str(ncomp), "0", f"({len(boxes)} 0"]
    lines += [_box(lo, arr.shape[1:]) for arr, lo in zip(boxes, locations)]
    lines += [")", str(len(boxes))]
    lines += [f"FabOnDisk: Cell_D_00000 {off}" for off in offsets]
    for table in (mins, maxs):
        lines += ["", f"{len(boxes)},{ncomp}"]
        lines += ["".join("%.16e," % v for v in row) for row in table]
    text = "\n".join(lines + [""]) + "\n"
    with open(os.path.join(lvl_dir, "Cell_H"), "w") as f:
        f.write(text)
    return written + len(text)


def write_plotfile(out_dir: str, snapshot, dataset) -> int:
    """Write one snapshot of ``dataset`` as the plotfile ``out_dir``;
    returns the bytes written."""
    os.makedirs(out_dir, exist_ok=True)
    ncomp = len(dataset.components)
    n_levels = len(snapshot.boxes)
    written = 0
    for lev in range(n_levels):
        written += _write_level(os.path.join(out_dir, f"Level_{lev}"),
                                snapshot.boxes[lev], snapshot.locations[lev],
                                ncomp)
    r = int(dataset.ref_ratio)
    dom = [tuple(int(b) * r ** lev for b in dataset.base_dims)
           for lev in range(n_levels)]
    lo = [float(v) for v in dataset.prob_lo]
    hi = [float(v) for v in dataset.prob_hi]
    dx = [[(hi[d] - lo[d]) / dom[lev][d] for d in range(3)]
          for lev in range(n_levels)]
    out = ["HyperCLaw-V1.1", str(ncomp), *dataset.components, "3",
           _g17(snapshot.time), str(n_levels - 1),
           " ".join(_g17(v) for v in lo) + " ",
           " ".join(_g17(v) for v in hi) + " ",
           "".join(f"{r} " for _ in range(n_levels - 1)),
           "".join(_box((0, 0, 0), dd) + " " for dd in dom),
           "".join(f"{int(snapshot.step)} " for _ in range(n_levels))]
    out += ["".join(_g17(v) + " " for v in dx[lev])
            for lev in range(n_levels)]
    out += ["0", "0"]
    for lev in range(n_levels):
        out.append(f"{lev} {len(snapshot.boxes[lev])} {_g17(snapshot.time)}")
        out.append(str(int(snapshot.step)))
        for arr, loc in zip(snapshot.boxes[lev], snapshot.locations[lev]):
            for d in range(3):
                g0 = lo[d] + dx[lev][d] * int(loc[d])
                g1 = lo[d] + dx[lev][d] * (int(loc[d]) + arr.shape[1 + d])
                out.append(f"{_g17(g0)} {_g17(g1)}")
        out.append(f"Level_{lev}/Cell")
    text = "\n".join(out) + "\n"
    with open(os.path.join(out_dir, "Header"), "w") as f:
        f.write(text)
    return written + len(text)


def write_dataset(root: str, dataset) -> int:
    """Write every snapshot under ``root``; returns the bytes written."""
    return sum(write_plotfile(os.path.join(root, s.name), s, dataset)
               for s in dataset.snapshots)
