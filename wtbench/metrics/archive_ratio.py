"""Float32 box bytes over the bytes of one pass's archive directory, all
of its files: what a user stores."""


def read(run):
    if run.produces != "archive" or not run.records:
        return None
    rec = run.records[0]
    return rec["f32_bytes"] / rec["archive_bytes"]
