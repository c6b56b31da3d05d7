"""wavelet_tpu_torch — the wavelet codec for AMReX plotfiles on PyTorch and
CUDA (NVIDIA Hopper), beside the JAX package ``wavelet_tpu``.

It keeps the JAX package's module names, so each part has a counterpart:

- ``core``      torch Haar transforms and per-box thresholds (the plain
                reference the kernels are held to);
- ``kernels``   hand-written CUDA kernels (``csrc/``), built with nvcc at
                first use, with their wrappers and launch counts;
- ``runtime``   the device codec engine and the host packer;
- ``pipeline``  the compress / decompress modes;
- ``api``, ``cli``  the entry points.

Host-side code with no backend in it (plotfile and archive I/O, the native
codec, RLE, batching) is imported from ``wavelet_tpu`` unchanged; nothing
here imports jax.
"""

__version__ = "0.1.0"

_API_NAMES = ("compress", "decompress")


def __getattr__(name):
    if name in _API_NAMES:
        from wavelet_tpu_torch import api
        return getattr(api, name)
    if name == "Config":
        from wavelet_tpu_torch.pipeline.common import Config
        return Config
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_API_NAMES) + ["Config"])
