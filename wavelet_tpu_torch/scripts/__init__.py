"""The port's measurement programs, each run as ``python -m
wavelet_tpu_torch.scripts.<name>``: ``bench_e2e`` (end-to-end compress and
decompress GB/s), ``scaling_bench`` (the collective steps over meshes of
1..N entries) and ``measure_baseline`` (BASELINE.json configs 3-6).  The
device-stage bench is :mod:`wavelet_tpu_torch.bench`."""
