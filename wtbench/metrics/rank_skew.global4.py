"""How far the slowest rank lags: over the window's passes, the sum of the
slowest rank's ``compress_seconds`` (span ``compress.run``) over the sum
of the ranks' mean, in % (100: no lag)."""


def read(run):
    slowest = mean = 0.0
    for r in run.records:
        secs = [st.get("compress_seconds") for st in r.get("rank_stats", [])]
        if not secs or None in secs:
            return None
        slowest += max(secs)
        mean += sum(secs) / len(secs)
    return 100.0 * slowest / mean if mean > 0 else None
