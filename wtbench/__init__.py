"""The benchmark of ``wavelet_tpu_torch`` on one NVIDIA GPU.

Run one cell once, from the root of a checkout::

    python3 -m wtbench.run --workload NAME --seed N --seconds S --trace 0|1

``BENCHMARK.json`` at the root names the cells.  Everything that belongs to
one configuration, traffic mix or metric sits in a file of its own, found
by name: ``configs/<config>.json`` with its generator ``datagen/<config>.py``,
``traffic/<traffic>.json``, whose ``kind`` names its driver
``drivers/<kind>.py``, and ``metrics/<metric>.py``.  ``reference/`` holds
the plain reference the outputs are judged by; it imports nothing of the
program.
"""
