"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and carries the ``cuda`` marker; on a
machine without CUDA each one skips.  The file imports no jax, so it also
runs on the GPU machine, where jax is not installed (tests/conftest.py
imports jax, so skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from wavelet_tpu.runtime import batching  # noqa: E402
from wavelet_tpu_torch.kernels import haar_cuda  # noqa: E402
from wavelet_tpu_torch.runtime import engine  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bits(t) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.int32)


def _batch(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 50).astype(np.float32)


@pytest.mark.parametrize("shape", [(32, 64, 64, 64), (3, 33, 17, 9),
                                   (2, 1, 1, 1), (5, 8, 4, 2)])
def test_kernels_match_plain(cuda_device, shape):
    x = torch.from_numpy(_batch(shape, 0)).to(cuda_device)
    c, mx, mn = haar_cuda.fused_forward(x)
    pc, pmx, pmn = haar_cuda.fused_forward_plain(x)
    np.testing.assert_array_equal(_bits(c), _bits(pc))
    # nonzero random data: no zero extremum, so the extrema are bitwise too
    np.testing.assert_array_equal(_bits(mx), _bits(pmx))
    np.testing.assert_array_equal(_bits(mn), _bits(pmn))
    np.testing.assert_array_equal(_bits(haar_cuda.fused_inverse(c)),
                                  _bits(haar_cuda.fused_inverse_plain(c)))


def test_cuda_tensors_launch_and_count(cuda_device):
    before = dict(haar_cuda.launches)
    x = torch.from_numpy(_batch((2, 8, 4, 2), 1)).to(cuda_device)
    haar_cuda.fused_inverse(haar_cuda.fused_forward(x)[0])
    assert haar_cuda.launches["haar_forward"] == before["haar_forward"] + 1
    assert haar_cuda.launches["haar_inverse"] == before["haar_inverse"] + 1


def test_engine_cuda_equals_cpu(cuda_device):
    dims = (9, 6, 4)
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(5)]
    data = _batch((5,) + dims, 2)
    outs = []
    for dev in ("cuda", "cpu"):
        eng = engine.CodecEngine(device=dev)
        batch = batching.ShapeBatch(shape=dims, data=data.copy(),
                                    items=items, n_valid=5)
        cb, t32 = eng.compress_shapebatch(batch, 0.999)
        outs.append((cb.data, t32, eng.decompress_shapebatch(cb).data))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
