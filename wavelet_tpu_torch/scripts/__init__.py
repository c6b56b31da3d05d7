"""The port's measurement programs, each run as ``python -m
wavelet_tpu_torch.scripts.<name>``: ``bench_e2e`` (end-to-end compress and
decompress GB/s), ``scaling_bench`` (the collective steps over meshes of
1..N entries), ``measure_baseline`` (BASELINE.json configs 3-6), and the
host benches ``bench_ragged`` (44 ragged box shapes end to end, held
against ``device=cpu``), ``bench_quality`` (the estimator's metrics at
scale), ``bench_host_codec`` (host pack/unpack beside the card's device
rates), ``fuzz_campaign`` (corrupt inputs) and ``bench_plotfile_io``
(plotfile read/write rates).  ``harness`` holds what they share.  The
device-stage bench is :mod:`wavelet_tpu_torch.bench`."""
