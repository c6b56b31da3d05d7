"""Long-run corruption campaign over every foreign-input surface of the port.

    python -m wavelet_tpu_torch.scripts.fuzz_campaign [--device cuda|cpu]
        [--trials-per 2000] [--seed 20260819] [--root DIR]
        [--out bench_results_torch/fuzz_campaign.json]

The counterpart of the JAX package's ``scripts/fuzz_campaign.py``, with
its mutations and campaigns (the same seed gives the same tally, surface
by surface, as the JAX script with its native codec off), on the port's
``io`` and ``core/rle``.  The clean-error contract: only
ValueError/OSError/KeyError/EOFError may escape a reader, over

  - plotfile Header / Cell_H / FAB payload bytes,
  - archive payload members (xz + raw, f32 + q16), on the port's one
    member codec (``backend_disagreements`` keeps the JAX script's
    schema, and is 0: the port has no second backend to compare),
  - the five sidecars of an archive that ``compress_run`` writes on
    ``--device``,
  - .wtb bundle containers.

Any other exception aborts the run.  Scratch files go in a directory of
the run's own made under ``--root`` (default: the temporary directory)
and removed at the end.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from wavelet_tpu_torch.core import rle
from wavelet_tpu_torch.io import archive, bundle as bundle_mod
from wavelet_tpu_torch.io import plotfile as pf
from wavelet_tpu_torch.pipeline.common import Config
from wavelet_tpu_torch.pipeline.compress import compress_run
from wavelet_tpu_torch.scripts import harness

__all__ = ["CLEAN", "mutate", "campaign_plotfile", "campaign_members",
           "campaign_sidecars", "campaign_bundle", "main"]

OUT = os.path.join("bench_results_torch", "fuzz_campaign.json")

CLEAN = (ValueError, OSError, KeyError, EOFError)


def mutate(blob: bytes, rng) -> bytes:
    b = bytearray(blob)
    kind = rng.integers(0, 5)
    if kind == 0 and len(b) > 1:
        return bytes(b[: rng.integers(1, len(b))])
    if kind == 1:
        for _ in range(int(rng.integers(1, 8))):
            b[rng.integers(0, len(b))] ^= int(rng.integers(1, 256))
        return bytes(b)
    if kind == 2:
        return bytes(rng.integers(0, 256, int(rng.integers(1, 512)),
                                  dtype=np.uint8))
    if kind == 3:
        lines = bytes(b).split(b"\n")
        if len(lines) > 1:
            del lines[rng.integers(0, len(lines))]
        return b"\n".join(lines)
    junk = bytes(rng.integers(0, 256, int(rng.integers(1, 64)),
                              dtype=np.uint8))
    return junk + bytes(b) if rng.integers(0, 2) else bytes(b) + junk


def campaign_plotfile(trials, rng, tally, root=None):
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        boxes = [rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
                 for _ in range(3)]
        d = os.path.join(tmp, "plt00010")
        pf.write_plotfile(d, [boxes], [[(0, 0, 0), (8, 0, 0), (0, 8, 0)]],
                          [[(8, 8, 8)] * 3], ["t"], 0.25, [0., 0., 0.],
                          [1., 1., 1.], (2, 2, 2), (16, 16, 8), [10])
        targets = ["Header", os.path.join("Level_0", "Cell_H"),
                   os.path.join("Level_0", "Cell_D_00000")]
        goods = {t: open(os.path.join(d, t), "rb").read() for t in targets}
        for t in targets:
            p = os.path.join(d, t)
            key = f"plotfile:{os.path.basename(t)}"
            tally[key] = {"trials": 0, "survived": 0, "rejected": 0}
            for _ in range(trials):
                with open(p, "wb") as f:
                    f.write(mutate(goods[t], rng))
                tally[key]["trials"] += 1
                try:
                    pf.read_header(d)
                    pf.read_level_meta(d, 0)
                    pf.read_level(d, 0, [0])
                    tally[key]["survived"] += 1
                except CLEAN:
                    tally[key]["rejected"] += 1
                # any other exception propagates and fails the campaign
            with open(p, "wb") as f:
                f.write(goods[t])
        pf.read_level(d, 0, [0])     # restored tree still reads


def campaign_members(trials, rng, tally, root=None):
    """Members decode in memory: ``root`` is the campaigns' common
    argument, and no file is written here."""
    dims, m = (8, 8, 8), 512
    for codec in ("xz", "raw"):
        for fmt in ("f32", "q16"):
            flat = np.zeros(m, np.float32)
            idx = rng.choice(m, 40, replace=False)
            flat[idx] = rng.standard_normal(40).astype(np.float32) * 10
            runs, vals = rle.rle_encode_mask(flat != 0, flat)
            ser = (archive.serialize_payload_q16 if fmt == "q16"
                   else archive.serialize_payload)
            good = archive.encode_blob(ser(dims, runs, vals), codec)
            key = f"member:{codec}/{fmt}"
            tally[key] = {"trials": 0, "survived": 0, "rejected": 0,
                          "backend_disagreements": 0}
            for t in range(trials):
                blob = mutate(good, rng)
                tally[key]["trials"] += 1
                try:
                    payload = archive.decode_blob(blob, codec)
                    de = (archive.deserialize_payload_q16 if fmt == "q16"
                          else archive.deserialize_payload)
                    sh, total, rr, vv = de(payload)
                    py = (rle.rle_decode(rr, vv, int(total))
                          if int(total) == m and tuple(sh) == dims
                          else None)
                except CLEAN:
                    py = None
                if py is None:
                    tally[key]["rejected"] += 1
                else:
                    tally[key]["survived"] += 1


def campaign_sidecars(trials, rng, tally, root=None, device="cuda"):
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        box = rng.standard_normal((8, 8, 8)).astype(np.float32)
        pf.write_plotfile(os.path.join(tmp, "data", "plt00080"),
                          [[box[None]]], [[(0, 0, 0)]], [[(8, 8, 8)]],
                          ["a"], 0.5, [0., 0., 0.], [1., 1., 1.],
                          (2, 2, 2), (8, 8, 8), [80])
        comp = os.path.join(tmp, "comp") + os.sep
        compress_run(Config(data_dir=os.path.join(tmp, "data"),
                            min_time="plt00080", max_time="plt00080",
                            min_level=0, max_level=0, components=["a"],
                            keep=0.999, compressed_dir=comp, device=device))
        readers = {
            "runinfo.raw": lambda: archive.read_runinfo(comp),
            "boxcounts.raw": lambda: archive.read_boxcounts(comp, 1, 1),
            "locations.raw": lambda: archive.read_locdim(
                comp, "locations.raw", [[1]]),
            "dimensions.raw": lambda: archive.read_locdim(
                comp, "dimensions.raw", [[1]]),
            "amrexinfo.raw": lambda: archive.read_amrexinfo(comp),
        }
        for name, read in readers.items():
            p = os.path.join(comp, name)
            good = open(p, "rb").read()
            key = f"sidecar:{name}"
            tally[key] = {"trials": 0, "survived": 0, "rejected": 0}
            for _ in range(trials):
                with open(p, "wb") as f:
                    f.write(mutate(good, rng))
                tally[key]["trials"] += 1
                try:
                    read()
                    tally[key]["survived"] += 1
                except CLEAN:
                    tally[key]["rejected"] += 1
            with open(p, "wb") as f:
                f.write(good)
            read()


def campaign_bundle(trials, rng, tally, root=None):
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        d = os.path.join(tmp, "arch")
        os.makedirs(d)
        w = bundle_mod.BundleWriter(
            os.path.join(d, bundle_mod.bundle_name(0, 0)))
        for b in range(4):
            flat = np.zeros(512, np.float32)
            flat[rng.choice(512, 20, replace=False)] = 1.0
            runs, vals = rle.rle_encode_mask(flat != 0, flat)
            w.add(0, 0, 0, b, archive.encode_blob(
                archive.serialize_payload((8, 8, 8), runs, vals), "raw"))
        w.close()
        path = os.path.join(d, bundle_mod.bundle_name(0, 0))
        good = open(path, "rb").read()
        key = "bundle:.wtb"
        tally[key] = {"trials": 0, "survived": 0, "rejected": 0}
        for _ in range(trials):
            with open(path, "wb") as f:
                f.write(mutate(good, rng))
            tally[key]["trials"] += 1
            try:
                bs = bundle_mod.BundleSet(d)
                for b in range(4):
                    if (0, 0, 0, b) in bs:
                        bs.blob(0, 0, 0, b)
                bs.close()
                tally[key]["survived"] += 1
            except CLEAN:
                tally[key]["rejected"] += 1
        with open(path, "wb") as f:
            f.write(good)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m wavelet_tpu_torch.scripts.fuzz_campaign",
        description="Corruption campaign over wavelet_tpu_torch's "
                    "foreign-input surfaces.")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--trials-per", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=20260819)
    ap.add_argument("--root", default=None,
                    help="the directory under which this run makes its own "
                         "(default: the temporary directory)")
    ap.add_argument("--out", default=OUT)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev, card = harness.device_card(args.device)
    rng = np.random.default_rng(args.seed)
    tally: dict = {}
    t0 = time.time()
    with harness.private_dir(args.root, "wtc_fuzz_") as root:
        campaign_plotfile(args.trials_per, rng, tally, root)
        campaign_members(args.trials_per, rng, tally, root)
        campaign_sidecars(args.trials_per, rng, tally, root, dev.type)
        campaign_bundle(args.trials_per, rng, tally, root)
    total = sum(v["trials"] for v in tally.values())
    out = {"timestamp": time.strftime("%Y-%m-%d %H:%M:%S"), "card": card,
           "device": dev.type, "seed": args.seed,
           "trials_per_surface": args.trials_per,
           "total_mutations": total,
           "seconds": round(time.time() - t0, 3),
           "escaped_exceptions": 0,     # any escape aborts the campaign
           "backend_disagreements": sum(
               v.get("backend_disagreements", 0) for v in tally.values()),
           "surfaces": tally}
    harness.write_json(args.out, out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
