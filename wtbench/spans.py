"""What the per-layer readers of the program's span keys share: a key's
sum over the window's passes, or None when no pass reported it (a program
without the span), so that such a metric is left out, not read as 0."""

from __future__ import annotations


def total(run, key: str):
    """Sum of the pipeline stat ``key`` over the window's passes, or None
    when no pass has it."""
    if not any(key in r["stats"] for r in run.records):
        return None
    return run.stat(key)


def s_per_gb(run, key: str):
    """Seconds of ``key`` per GB of float32 boxes of the window."""
    v = total(run, key)
    gb = run.total("f32_bytes") / 1e9 if run.records else 0.0
    return v / gb if v is not None and gb > 0 else None


def ratio(run, num: str, den: str, scale: float = 1.0):
    """``num`` over ``den``, times ``scale``; None when either is absent or
    ``den`` is 0."""
    a, b = total(run, num), total(run, den)
    return a / b * scale if a is not None and b else None
