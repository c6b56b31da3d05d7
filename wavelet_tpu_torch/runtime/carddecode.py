"""The card's share of a streamed decode bucket: which members it takes,
and their launch.

A streamed bucket (``pipeline/decompress._stream_rows``) decodes its
members largest first on the host packer's pool.  Where the card can
finish a tail of the smallest members no later than the pool finishes the
rest, :func:`card_count` gives it that tail: one block a member of the
``xzdec`` kernel (``kernels/xzdec_cuda``) decodes each member on its own
CUDA stream and writes its row straight into the device tensor that the
inverse kernel reads, while the pool decodes the others.

The choice adapts to what the process observes, with no option: each
member's stored (xz) size, the host's decode rate a core (the stored
bytes of the streamed buckets' host members over their pools' walls
times the workers they kept, fed by ``pipeline/decompress``), and the
card's rate a stream (probed once a process, then the kernel's own
per-member timings), both in stored bytes a second and kept in
:data:`RATES`.  A member's decode is a serial chain of bit decodes whose
length follows its stored bits more closely than its payload bytes, so
its stored size predicts both sides' time.
Until both rates are known a bucket gets no card members, and so does a
bucket where the card cannot finish first: small boxes, few members.

The card's statuses route a member back to the host reader where the
card declines what it does not take (another container, a later
dictionary reset, a payload that disagrees with the box, a run the
vectorised scatter does not take).  A member of the buffer encoder's
layout whose LZMA2 data or CRC64 the card rejects must be corrupt: where
the host reader decodes it all the same, the kernel is at fault, and
:meth:`CardDecode.kernel_faults` names it so that the caller raises.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from wavelet_tpu_torch.io import archive
from wavelet_tpu_torch.kernels import xzdec_cuda
from wavelet_tpu_torch.runtime.debug import span

__all__ = ["card_count", "host_seconds", "CardRates", "RATES",
           "CardDecode"]

# the payload of the card probe: one member of 8,191 pairs in a 32^3 box,
# values of a random walk (literal-heavy, as kept coefficients are)
_PROBE_PAIRS = 8191
_PROBE_DIMS = (32, 32, 32)


def host_seconds(sizes, host_bps: float, workers: int) -> float:
    """The host pool's predicted decode of members of ``sizes`` (largest
    first): their bytes over ``workers * host_bps``, and never less than
    the largest over ``host_bps``."""
    if not sizes:
        return 0.0
    return max(sum(sizes) / (workers * host_bps), sizes[0] / host_bps)


def card_count(sizes, *, host_bps: float | None, workers: int,
               card_bps: float | None, sms: int, launch_s: float = 0.0,
               head_s: float = 0.0) -> int:
    """How many of a bucket's members the card takes: ``k``, the card
    decoding ``sizes[n - k:]`` (``sizes``: the members' stored bytes,
    largest first) and the host the rest.

    Predicted finishes, from the start of the bucket's host decode: the
    card's, ``launch_s`` plus, for each wave of ``sms`` blocks (its members
    largest first), the wave's largest member over ``card_bps`` (stored
    bytes a second a stream, as ``host_bps`` is a core), less ``head_s``,
    the seconds by which the card's launch precedes the bucket (a launch
    one timestep ahead); the host's,
    :func:`host_seconds`.  ``k`` minimises the later of the two, the
    smallest such ``k`` where several tie; 0 where either rate is unknown
    or no ``k`` beats the host alone."""
    n = len(sizes)
    if not n or not host_bps or not card_bps or workers < 1 or sms < 1:
        return 0
    sizes = [float(s) for s in sizes]
    rest = sum(sizes)
    best_t, best_k = host_seconds(sizes, host_bps, workers), 0
    for k in range(1, n + 1):
        rest -= sizes[n - k]
        card = sizes[n - k:]            # largest first
        card_t = (launch_s - head_s
                  + sum(card[w] for w in range(0, k, sms)) / card_bps)
        host_t = (max(rest / (workers * host_bps), sizes[0] / host_bps)
                  if k < n else 0.0)
        t = max(card_t, host_t)
        if t < best_t:
            best_t, best_k = t, k
    return best_k


class CardRates:
    """The rates :func:`card_count` takes, in stored bytes, kept for the
    process (a caller may build a new packer for every pass): the host's,
    stored bytes over core-seconds of wall, summed over the streamed
    buckets' host members (a pool's wall from its start to its last
    member, times the workers its members kept busy: what a worker
    delivers beside the others and the calling thread, not its bare CPU
    rate); the card's, stored bytes a second of one block, summed over
    every member the kernel decoded (the probe's first); and the probe's
    launch overhead (its wall less its kernel time)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.host = [0, 0.0]        # stored bytes, core-seconds of wall
        self.card = [0, 0.0]        # stored bytes, kernel seconds
        self.launch_s = 0.0
        self.probed = set()         # devices probed

    def add_host(self, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.host[0] += nbytes
            self.host[1] += seconds

    def add_card(self, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.card[0] += nbytes
            self.card[1] += seconds

    @staticmethod
    def _rate(pair):
        return pair[0] / pair[1] if pair[1] > 0 else None

    def host_bps(self):
        return self._rate(self.host)

    def card_bps(self, device):
        """The card's rate, probing ``device`` once first."""
        if device.type == "cuda" and device not in self.probed:
            self.probed.add(device)
            self._probe(device)
        return self._rate(self.card)

    def _probe(self, device) -> None:
        """One member decoded on ``device``: its kernel time gives the first
        rate a stream, and its wall less that the launch overhead.  The
        member is the buffer encoder's own, so a status other than 0 is
        the kernel's fault, and raises."""
        rng = np.random.default_rng(_PROBE_PAIRS)
        vals = np.cumsum(rng.standard_normal(_PROBE_PAIRS)).astype(
            np.float32)
        runs = rng.integers(0, 3, _PROBE_PAIRS).astype(np.int32)
        blob = archive.xz_compress(
            archive.serialize_payload(_PROBE_DIMS, runs, vals))
        t0 = time.perf_counter()
        card = CardDecode(device, _PROBE_DIMS, [blob])
        card.close()
        wall = time.perf_counter() - t0
        _, stored, secs, _ = card.finish()
        if card.status[0] != xzdec_cuda.OK:
            raise RuntimeError(f"xzdec: the probe member, the buffer "
                               f"encoder's own, got status "
                               f"{int(card.status[0])} on {device}")
        self.add_card(stored, secs)
        self.launch_s = max(0.0, wall - secs)


RATES = CardRates()


_N_STREAMS = 4


class _Streams:
    """The CUDA streams of the card's decodes, :data:`_N_STREAMS` a device,
    made at first use and handed out in turn, so that a launch made one
    timestep ahead runs beside the current timestep's."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_device = {}

    def get(self, device):
        with self._lock:
            ring = self._by_device.get(device)
            if ring is None:
                ring = self._by_device[device] = [
                    [torch.cuda.Stream(device) for _ in range(_N_STREAMS)],
                    0]
            ring[1] = (ring[1] + 1) % _N_STREAMS
            return ring[0][ring[1]]


_STREAMS = _Streams()


class CardDecode:
    """The launch of one tail of a bucket: ``blobs`` (the members' stored
    bytes, in row order) staged in one pinned buffer, copied up once and
    decoded by the ``xzdec`` kernel on a stream of the card's into ``rows``
    (``[k, X, Y, Z]`` f32, zeroed, on ``device``); ``event`` marks the
    end.  A member whose container is not the buffer encoder's layout
    (:func:`archive.xz_single_block`) gets no bytes, so its block reports
    a non-zero status at once.  On a CPU device the plain version runs
    here, in the constructor.  ``h2d_bytes`` are the staged bytes;
    ``sizes`` and ``stored`` each member's payload and stored bytes (0
    where it gets none), ``accepted`` whether its container was taken."""

    def __init__(self, device, dims, blobs):
        self.device = device = torch.device(device)
        k = len(blobs)
        layouts = [archive.xz_single_block(b) for b in blobs]
        desc = np.zeros((k, xzdec_cuda.DESC_FIELDS), np.int64)
        in_off = out_off = 0
        self.sizes = [0] * k
        self.stored = [0] * k
        self.accepted = [lay is not None for lay in layouts]
        for j, (blob, lay) in enumerate(zip(blobs, layouts)):
            if lay is None:
                continue
            data, comp, unc, crc = lay
            desc[j] = (in_off + data, comp, unc,
                       crc - (1 << 64) if crc >> 63 else crc, out_off)
            self.sizes[j] = unc
            self.stored[j] = len(blob)
            in_off += -(-len(blob) // 16) * 16
            out_off += -(-unc // 16) * 16
        staged = torch.empty(in_off + xzdec_cuda.SLACK, dtype=torch.uint8,
                             pin_memory=device.type == "cuda")
        buf = staged.numpy()
        for blob, lay, d in zip(blobs, layouts, desc):
            if lay is not None:
                at = int(d[0]) - lay[0]
                buf[at:at + len(blob)] = np.frombuffer(blob, np.uint8)
        self.h2d_bytes = int(staged.numel() + desc.nbytes)
        cuda = device.type == "cuda"
        self._stream = _STREAMS.get(device) if cuda else None
        self.enqueued = time.perf_counter()
        desc_t = torch.from_numpy(desc)
        with (torch.cuda.stream(self._stream) if cuda
              else contextlib.nullcontext()):
            if cuda:
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record(self._stream)
            blob_dev = staged.to(device, non_blocking=True)
            desc_dev = (desc_t.pin_memory() if cuda else desc_t).to(
                device, non_blocking=True)
            scratch = torch.empty(max(out_off, 16), dtype=torch.uint8,
                                  device=device)
            self.rows = torch.zeros((k,) + tuple(dims), dtype=torch.float32,
                                    device=device)
            self._status, self._ticks = xzdec_cuda.decode_rows(
                blob_dev, desc_dev, scratch, self.rows)
            self.event = (torch.cuda.Event(enable_timing=True) if cuda
                          else None)
            if cuda:
                self.event.record(self._stream)
        self._keep = (staged, blob_dev, desc_dev, scratch)
        self.done = time.perf_counter() if not cuda else None
        self.status = None

    def ready(self) -> bool:
        """Whether the card has finished (without waiting)."""
        return self.event is None or self.event.query()

    def wait(self, stats: dict) -> torch.Tensor:
        """Wait for the card (span ``decompress.card_wait``,
        ``card_wait_seconds``), order the current stream after it, add the
        card's counters to ``stats`` and its timings to :data:`RATES`;
        -> the rows.  ``status`` then holds each member's status and
        ``done`` the ``perf_counter`` at which the card finished."""
        with span("decompress.card_wait", stats, "card_wait_seconds"):
            if self.event is not None:
                self.event.synchronize()
        if self.event is not None:
            torch.cuda.current_stream(self.device).wait_event(self.event)
            self.rows.record_stream(torch.cuda.current_stream(self.device))
            self.done = self.enqueued + self._start.elapsed_time(
                self.event) / 1e3
        nbytes, stored, secs, declined = self.finish()
        RATES.add_card(stored, secs)
        for key, v in (("card_decoded_members", len(self.status) - declined),
                       ("card_decoded_bytes", nbytes),
                       ("card_declined_members", declined),
                       ("card_decode_seconds", secs)):
            stats[key] = stats.get(key, 0) + v
        return self.rows

    def finish(self):
        """The finished launch's results: -> (payload bytes, stored bytes
        and kernel seconds of the members it decoded, the count it
        declined); ``status`` holds each member's status."""
        self.status = self._status.cpu().numpy()
        ticks = self._ticks.cpu().numpy()
        self._keep = None
        ok = self.status == xzdec_cuda.OK
        secs = float(np.sum((ticks[:, 1] - ticks[:, 0])[ok])) / 1e9
        return (int(np.sum(np.asarray(self.sizes, np.int64)[ok])),
                int(np.sum(np.asarray(self.stored, np.int64)[ok])), secs,
                int(np.count_nonzero(~ok)))

    def kernel_faults(self) -> list:
        """The finished members whose container the card took and whose
        LZMA2 data or CRC64 it rejected (``DATA_ERROR``, ``CHECK_ERROR``):
        once the host reader has decoded them without an error, each is
        the kernel failing on a valid member."""
        return [j for j, (s, ok) in enumerate(zip(self.status,
                                                  self.accepted))
                if ok and s in (xzdec_cuda.DATA_ERROR,
                                xzdec_cuda.CHECK_ERROR)]

    def close(self) -> None:
        """Wait for the card's work, if it is still running (a bucket that
        raised before its wait)."""
        if self.event is not None:
            self.event.synchronize()

