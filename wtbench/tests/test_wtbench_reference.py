"""The plain reference against the program's CPU path, the control, and
faults planted in the program: each must move ``correct`` the right way."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from wtbench import control, drivers
from wtbench.reference import check, codec
from wtbench.tests import tiny


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_program_cpu_path_matches_reference(cell):
    r = tiny.run_cell(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert all(v["value"] == 0 for v in r["checks"].values())
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", ["nyx_rank64.compress", "nyx_rank64.regen"])
def test_traced_run_reads_per_layer_metrics(cell):
    r = tiny.run_cell(cell, trace=True)
    assert r["correct"]
    assert r["metrics"], r
    assert "window_s" in r["device"] and "breakdown" in r
    # no device on the CPU: no idle share, no roofline
    assert not any("idle" in k or "roofline" in k for k in r["metrics"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_lower_precision_control_is_not_correct(cell, dtype):
    bench = tiny.TinyBench()
    numbers = control.control_numbers(bench, bench.cell(cell), tiny.SEED,
                                      "cpu", dtype)
    limits = drivers.load(bench.traffic(bench.cell(cell)["traffic"])["kind"]).LIMITS
    assert not check.verdict(numbers, limits), numbers


def _forward_unchanged(x):
    flat = x.reshape(x.shape[0], -1)
    return x.clone(), flat.amax(1), flat.amin(1)


def _patch_fault(monkeypatch, fault: str, kind: str):
    from wavelet_tpu_torch.kernels import haar_cuda
    from wavelet_tpu_torch.runtime import engine

    if fault == "state_unchanged":
        if kind == "compress":
            monkeypatch.setattr(haar_cuda, "fused_forward", _forward_unchanged)
        else:
            monkeypatch.setattr(haar_cuda, "fused_inverse", lambda c: c.clone())
    elif fault == "half_batch_left_out":
        if kind == "compress":
            orig = engine.HostPacker.pack

            def pack(self, out_dir, coeff_batch, t32, subset=None):
                n = len(coeff_batch.items)
                return orig(self, out_dir, coeff_batch, t32,
                            subset=list(range(max(1, n // 2))))
            monkeypatch.setattr(engine.HostPacker, "pack", pack)
        else:
            orig = engine.CodecEngine.decompress_shapebatch

            def half(self, coeff_batch):
                out = orig(self, coeff_batch)
                out.data[max(1, out.data.shape[0] // 2):] = 0.0
                return out
            monkeypatch.setattr(engine.CodecEngine, "decompress_shapebatch",
                                half)
    elif fault == "answer_altered":
        if kind == "compress":
            orig = engine.CodecEngine.compress_shapebatch

            def alter(self, batch, keep):
                cb, t32 = orig(self, batch, keep)
                cb.data.reshape(-1)[0] = cb.data.reshape(-1)[0] * 2 + 1
                return cb, t32
            monkeypatch.setattr(engine.CodecEngine, "compress_shapebatch",
                                alter)
        else:
            orig = engine.CodecEngine.decompress_shapebatch

            def alter_out(self, coeff_batch):
                out = orig(self, coeff_batch)
                out.data.reshape(-1)[0] = out.data.reshape(-1)[0] * 2 + 1
                return out
            monkeypatch.setattr(engine.CodecEngine, "decompress_shapebatch",
                                alter_out)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    kind = tiny.TinyBench().traffic(tiny.TinyBench().cell(cell)["traffic"])["kind"]
    _patch_fault(monkeypatch, fault, kind)
    r = tiny.run_cell(cell)
    assert not r["correct"], (fault, r["checks"])
    assert r["failed"] >= 1


def test_reference_haar_roundtrip():
    g = torch.Generator().manual_seed(5)
    x = torch.randn((3, 8, 4, 6), generator=g)
    c = codec.forward(x)
    assert torch.allclose(codec.inverse(c), x, atol=1e-6)
    # a constant box keeps its value in the one-scale low corner only
    k = torch.full((1, 4, 4, 4), 3.0)
    assert int(codec.kept_counts(k, 0.999)[0]) == 8


def test_reference_threshold_takes_first_of_tied_extrema():
    # |max| ties between -2 (first) and +2: the threshold is negative, so
    # every coefficient is kept, as the reference tool does
    c = torch.tensor([[-2.0, 0.0, 2.0, 1e-9]])
    thr = codec.thresholds(c, 0.999)
    assert float(thr[0]) < 0
    assert codec.kept_mask(c, thr).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(tiny.TINY))
def test_reference_on_the_card_equals_the_cpu(config, cuda_device):
    bench = tiny.TinyBench()
    from wtbench import datagen

    ds = datagen.generate(config, bench.config(config), tiny.SEED, "cpu")
    on_cpu = check.reference_payloads(ds, 0.999, "cpu")
    on_card = check.reference_payloads(ds, 0.999, cuda_device)
    assert on_cpu == on_card
    box = torch.from_numpy(ds.snapshots[0].boxes[0][0])
    assert np.array_equal(codec.regenerate(box, 0.999).numpy(),
                          codec.regenerate(box.cuda(), 0.999).cpu().numpy())
