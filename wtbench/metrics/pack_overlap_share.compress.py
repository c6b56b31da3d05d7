"""Share of the compress call's reads and device steps (spans
``compress.read``, ``compress.device_step``: ``read_seconds``,
``device_seconds``) that ran while members of an earlier batch were still
packing (``pack_overlap_seconds``), %."""

from wtbench.spans import total


def read(run):
    over = total(run, "pack_overlap_seconds")
    busy = (total(run, "read_seconds") or 0.0) + \
        (total(run, "device_seconds") or 0.0)
    return 100.0 * over / busy if over is not None and busy > 0 else None
