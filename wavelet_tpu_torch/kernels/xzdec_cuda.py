"""xz members decoded on the card, one block a member, straight into the
coefficient rows the inverse kernel reads: wrapper, plain version and
launch count.

:func:`decode_rows` ``(blob uint8 [B], desc int64 [k, 5], scratch uint8
[S], rows f32 [k, X, Y, Z]) -> (status int32 [k], ticks int64 [k, 2])``.
Member j's LZMA2 data is ``blob[in_off : in_off + comp]`` (``desc[j] =
(in_off, comp, unc, crc64, out_off)``, the first four from
:func:`wavelet_tpu_torch.io.archive.xz_single_block`); it decodes to
``unc`` bytes at ``scratch[out_off:]``, which must meet the CRC64 ``crc64``
(its 64 bits stored as a signed int64).  The payload is then checked
against ``rows``' box shape as ``HostPacker._decode`` checks it, and its
(run, value) pairs are written into the zeroed row ``rows[j]`` at the
positions ``cumsum(runs + 1) - 1``, as ``core/rle.rle_decode`` writes them
where every run is >= 0 and the last position lies in the box.
Every member's bytes must be followed by :data:`SLACK` more bytes of
``blob`` (the kernel reads ahead, and a corrupt member at most that far
past its end).  ``status[j]`` is 0 where the row was written; any other value (the codes
below) leaves the row as it was, and the caller hands that member to the
host reader, which decodes it, or raises its own ``ValueError``.
``ticks[j]`` are the member's start and end in nanoseconds (the card's
``%globaltimer``; the host's ``perf_counter_ns`` in the plain version).

The kernel (CUDA C++, ``wavelet_tpu_torch/csrc/xzdec.cu``,
``xzdec_kernel``) replaces no TPU kernel: the JAX package decodes every
member on the host.  A CUDA tensor launches it or raises; a CPU tensor
goes to :func:`decode_rows_plain`, which decodes the same way in Python
(:func:`lzma2_decode_plain`, the probability layout and the status codes
are the kernel's) and is what the kernel is held to.  ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import struct
import time

import numpy as np
import torch

__all__ = ["decode_rows", "decode_rows_plain", "lzma2_decode_plain",
           "crc64", "launches", "reset_launches", "OK", "DATA_ERROR",
           "DICT_RESET", "CHECK_ERROR", "PAYLOAD_ERROR", "RUNS_DECLINED",
           "DESC_FIELDS", "SLACK"]

launches = {"xzdec": 0}

# status codes, as csrc/xzdec.cu writes them
OK = 0
DATA_ERROR = 1      # the LZMA2 data is not what liblzma would accept
DICT_RESET = 2      # a dictionary reset after the first byte (declined)
CHECK_ERROR = 3     # the output does not meet the block's CRC64
PAYLOAD_ERROR = 4   # shape, total or pair count disagree with the box
RUNS_DECLINED = 5   # a negative run or a position past the box

DESC_FIELDS = 5     # in_off, comp, unc, crc64, out_off
# bytes of the blob that must follow a member's (the kernel reads ahead)
SLACK = 64

# the probability model's layout, one uint16 array (csrc/xzdec.cu's too)
_IS_MATCH = 0               # [12 states][16 pos states]
_IS_REP = 192               # [12]
_IS_REP0 = 204
_IS_REP1 = 216
_IS_REP2 = 228
_IS_REP0_LONG = 240         # [12][16]
_DIST_SLOT = 432            # [4][64]
_DIST_SPECIAL = 688         # [114]
_DIST_ALIGN = 802           # [16]
_MATCH_LEN = 822            # choice, choice2, low [16][8], mid [16][8],
_REP_LEN = 1342             # high [256]: 514 each (each tree 8-byte aligned)
_LITERAL = 1856             # [0x300 << (lc + lp)], lc + lp <= 4
N_PROBS = _LITERAL + (0x300 << 4)

_M32 = 0xFFFFFFFF
_TOP = 1 << 24


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _crc64_table():
    poly = 0xC96C5795D7870F42       # ECMA-182, reflected: xz's CRC64
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (poly if c & 1 else 0)
        table.append(c)
    return table


_CRC64 = _crc64_table()


def crc64(data) -> int:
    """xz's CRC64 of ``data``."""
    c = 0xFFFFFFFFFFFFFFFF
    t = _CRC64
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFFFFFFFFFF


class _Bad(Exception):
    def __init__(self, status: int):
        self.status = status


def lzma2_decode_plain(data, unc: int):
    """LZMA2 ``data`` (a block's whole compressed data) -> ``(status,
    bytes, bits)``: ``(OK, the unc decoded bytes, ...)`` where liblzma's
    LZMA2 decoder would give exactly ``unc`` bytes and consume exactly
    ``data``, else ``(DATA_ERROR or DICT_RESET, partial output, ...)``;
    ``bits`` counts the range coder's bit decodes, the kernel's serial
    chain.  The rules are
    liblzma's: the first chunk resets the dictionary, an LZMA chunk after a
    dictionary reset sets new properties (lc + lp <= 4), a range coder's
    first byte is 0 and its code is 0 once the chunk's bytes are spent, a
    chunk's match never runs past the chunk, and no match reaches before
    the first byte.  A dictionary reset after the first byte, legal but
    never written by the buffer encoder, is declined."""
    data = bytes(data)
    comp = len(data)
    out = bytearray()
    probs = [1024] * N_PROBS
    rng = code = cip = cend = bits = 0

    def bit(i):
        nonlocal rng, code, cip, bits
        bits += 1
        if rng < _TOP:
            if cip >= cend:
                raise _Bad(DATA_ERROR)
            rng = (rng << 8) & _M32
            code = ((code << 8) | data[cip]) & _M32
            cip += 1
        p = probs[i]
        bound = (rng >> 11) * p
        if code < bound:
            rng = bound
            probs[i] = p + ((2048 - p) >> 5)
            return 0
        rng -= bound
        code -= bound
        probs[i] = p - (p >> 5)
        return 1

    def tree(base, limit):
        sym = 1
        while sym < limit:
            sym = (sym << 1) | bit(base + sym)
        return sym - limit

    def reverse(base, nbits):
        sym, res = 1, 0
        for i in range(nbits):
            b = bit(base + sym)
            sym = (sym << 1) | b
            res |= b << i
        return res

    def direct(nbits):
        nonlocal rng, code, cip, bits
        bits += nbits
        res = 0
        for _ in range(nbits):
            if rng < _TOP:
                if cip >= cend:
                    raise _Bad(DATA_ERROR)
                rng = (rng << 8) & _M32
                code = ((code << 8) | data[cip]) & _M32
                cip += 1
            rng >>= 1
            b = 1 if code >= rng else 0
            code -= rng & -b
            res = (res << 1) | b
        return res

    def length(base, ps):
        if not bit(base):
            return 2 + tree(base + 2 + ps * 8, 8)
        if not bit(base + 1):
            return 10 + tree(base + 130 + ps * 8, 8)
        return 18 + tree(base + 258, 256)

    state = rep0 = rep1 = rep2 = rep3 = 0
    lc = lp = pb = 0
    need_dict_reset = need_props = True
    ip = 0
    try:
        while True:
            if ip >= comp:
                raise _Bad(DATA_ERROR)
            control = data[ip]
            ip += 1
            if control == 0x00:
                break
            pos = len(out)
            if control >= 0xE0 or control == 0x01:
                if pos:
                    raise _Bad(DICT_RESET)
                need_props, need_dict_reset = True, False
            elif need_dict_reset:
                raise _Bad(DATA_ERROR)
            if control < 0x80:
                if control > 0x02 or ip + 2 > comp:
                    raise _Bad(DATA_ERROR)
                size = (data[ip] << 8 | data[ip + 1]) + 1
                ip += 2
                if size > unc - pos or size > comp - ip:
                    raise _Bad(DATA_ERROR)
                out += data[ip:ip + size]
                ip += size
                continue
            if ip + 4 > comp:
                raise _Bad(DATA_ERROR)
            usize = ((control & 0x1F) << 16 | data[ip] << 8
                     | data[ip + 1]) + 1
            csize = (data[ip + 2] << 8 | data[ip + 3]) + 1
            ip += 4
            if control >= 0xC0:
                if ip >= comp or data[ip] >= 9 * 5 * 5:
                    raise _Bad(DATA_ERROR)
                props = data[ip]
                ip += 1
                lc, lp, pb = props % 9, props // 9 % 5, props // 45
                if lc + lp > 4:
                    raise _Bad(DATA_ERROR)
                need_props = False
            elif need_props:
                raise _Bad(DATA_ERROR)
            if control >= 0xA0:
                probs[:] = [1024] * N_PROBS
                state = rep0 = rep1 = rep2 = rep3 = 0
            if (usize > unc - pos or csize > comp - ip or csize < 5
                    or data[ip] != 0):
                raise _Bad(DATA_ERROR)
            code = int.from_bytes(data[ip + 1:ip + 5], "big")
            rng, cip, cend = _M32, ip + 5, ip + csize
            end = pos + usize
            pb_mask, lp_mask = (1 << pb) - 1, (1 << lp) - 1
            while pos < end:
                ps = pos & pb_mask
                if not bit(_IS_MATCH + state * 16 + ps):
                    prev = out[pos - 1] if pos else 0
                    base = _LITERAL + 0x300 * (((pos & lp_mask) << lc)
                                               + (prev >> (8 - lc)))
                    sym = 1
                    if state < 7:
                        while sym < 0x100:
                            sym = (sym << 1) | bit(base + sym)
                    else:
                        match = out[pos - rep0 - 1] << 1
                        offset = 0x100
                        while sym < 0x100:
                            mbit = match & offset
                            match <<= 1
                            b = bit(base + offset + mbit + sym)
                            sym = (sym << 1) | b
                            offset &= mbit if b else ~mbit
                    out.append(sym & 0xFF)
                    pos += 1
                    state = 0 if state < 4 else (state - 3 if state < 10
                                                 else state - 6)
                    continue
                if bit(_IS_REP + state):
                    n = 0
                    if not bit(_IS_REP0 + state):
                        if not bit(_IS_REP0_LONG + state * 16 + ps):
                            state = 9 if state < 7 else 11
                            n = 1
                    else:
                        if not bit(_IS_REP1 + state):
                            dist = rep1
                        else:
                            if not bit(_IS_REP2 + state):
                                dist = rep2
                            else:
                                dist, rep3 = rep3, rep2
                            rep2 = rep1
                        rep1, rep0 = rep0, dist
                    if not n:
                        state = 8 if state < 7 else 11
                        n = length(_REP_LEN, ps)
                else:
                    rep3, rep2, rep1 = rep2, rep1, rep0
                    n = length(_MATCH_LEN, ps)
                    state = 7 if state < 7 else 10
                    slot = tree(_DIST_SLOT + 64 * min(n - 2, 3), 64)
                    if slot < 4:
                        rep0 = slot
                    else:
                        nb = (slot >> 1) - 1
                        rep0 = (2 | slot & 1) << nb
                        if slot < 14:
                            rep0 += reverse(_DIST_SPECIAL + rep0 - slot - 1,
                                            nb)
                        else:
                            rep0 += direct(nb - 4) << 4
                            rep0 += reverse(_DIST_ALIGN, 4)
                if rep0 >= pos or n > end - pos:
                    raise _Bad(DATA_ERROR)
                src = pos - rep0 - 1
                for k in range(n):
                    out.append(out[src + k])
                pos += n
            # the range coder is left normalized, and then spent
            if rng < _TOP:
                if cip >= cend:
                    raise _Bad(DATA_ERROR)
                code = ((code << 8) | data[cip]) & _M32
                cip += 1
            if code != 0 or cip != cend:
                raise _Bad(DATA_ERROR)
            ip = cend
        if len(out) != unc or ip != comp:
            raise _Bad(DATA_ERROR)
    except _Bad as e:
        return e.status, bytes(out), bits
    return OK, bytes(out), bits


def payload_into_row(payload: bytes, row: torch.Tensor) -> int:
    """Check a decoded payload against ``row``'s box ``(X, Y, Z)`` and
    write its pairs into the zeroed ``row``; -> the status (``OK``,
    ``PAYLOAD_ERROR`` or ``RUNS_DECLINED``, the row untouched)."""
    dims = tuple(int(d) for d in row.shape)
    m = dims[0] * dims[1] * dims[2]
    if len(payload) < 20:
        return PAYLOAD_ERROR
    x, y, z, total, n = struct.unpack_from("<5i", payload, 0)
    if (x, y, z) != dims or total != m or n < 0 or 20 + 8 * n > len(payload):
        return PAYLOAD_ERROR
    if n == 0:
        return OK
    pairs = np.frombuffer(payload, "<i4", 2 * n, 20).reshape(n, 2)
    runs = pairs[:, 0].astype(np.int64)
    if runs.min() < 0:
        return RUNS_DECLINED
    pos = np.cumsum(runs + 1) - 1
    if pos[-1] >= m:
        return RUNS_DECLINED
    row.view(-1).view(torch.int32)[torch.from_numpy(pos)] = torch.from_numpy(
        np.ascontiguousarray(pairs[:, 1]))
    return OK


def decode_rows_plain(blob: torch.Tensor, desc: torch.Tensor,
                      scratch: torch.Tensor, rows: torch.Tensor):
    """The kernel's work in Python, member after member: the LZMA2 decode
    into ``scratch``, its CRC64, the payload's checks and the row's
    writes; -> ``(status int32 [k], ticks int64 [k, 2])``."""
    data = blob.numpy().tobytes()
    k = desc.shape[0]
    n_scratch = scratch.numel()
    status = torch.zeros(k, dtype=torch.int32)
    ticks = torch.zeros((k, 2), dtype=torch.int64)
    sview = scratch.numpy()
    for j, (in_off, comp, unc, crc, out_off) in enumerate(desc.tolist()):
        t0 = time.perf_counter_ns()
        if (min(in_off, unc, out_off) < 0 or comp <= 0 or out_off % 4
                or in_off + comp + SLACK > len(data)
                or out_off + unc > n_scratch or unc >= 1 << 32):
            s, out = DATA_ERROR, b""
        else:
            s, out, _ = lzma2_decode_plain(data[in_off:in_off + comp], unc)
        sview[out_off:out_off + len(out)] = np.frombuffer(out, np.uint8)
        if s == OK and crc64(out) != crc & 0xFFFFFFFFFFFFFFFF:
            s = CHECK_ERROR
        if s == OK:
            s = payload_into_row(out, rows[j])
        status[j] = s
        ticks[j, 0], ticks[j, 1] = t0, time.perf_counter_ns()
    return status, ticks


def _check(blob, desc, scratch, rows) -> None:
    for t, dt, what in ((blob, torch.uint8, "blob"),
                        (desc, torch.int64, "desc"),
                        (scratch, torch.uint8, "scratch"),
                        (rows, torch.float32, "rows")):
        if t.dtype != dt:
            raise TypeError(f"xzdec: {what} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"xzdec: {what} must be contiguous")
        if t.device != rows.device:
            raise ValueError(f"xzdec: {what} on {t.device}, rows on "
                             f"{rows.device}")
    if blob.dim() != 1 or scratch.dim() != 1 or rows.dim() != 4:
        raise ValueError("xzdec: expected blob [B], scratch [S] and rows "
                         "[k, X, Y, Z]")
    if not 0 < blob.numel() < 2**32:
        raise ValueError(f"xzdec: blob of {blob.numel()} bytes, outside "
                         "1 B to 4 GiB")
    k = rows.shape[0]
    if tuple(desc.shape) != (k, DESC_FIELDS):
        raise ValueError(f"xzdec: desc shape {tuple(desc.shape)} != "
                         f"({k}, {DESC_FIELDS})")
    if k and rows[0].numel() >= 2**31:
        raise ValueError("xzdec: a box of 2^31 or more cells")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"xzdec: unsupported device {rows.device}")


def decode_rows(blob: torch.Tensor, desc: torch.Tensor,
                scratch: torch.Tensor, rows: torch.Tensor):
    """-> ``(status int32 [k], ticks int64 [k, 2])`` (see the module;
    a member whose bytes lie outside ``blob`` or ``scratch`` gets
    ``DATA_ERROR``).  On a CUDA device the launch goes on the current
    stream and nothing waits for it."""
    _check(blob, desc, scratch, rows)
    if rows.device.type == "cpu":
        return decode_rows_plain(blob, desc, scratch, rows)
    from wavelet_tpu_torch.kernels import build
    from wavelet_tpu_torch.kernels.haar_cuda import _raise_if, _stream

    lib = build.library()
    k, X, Y, Z = (int(d) for d in rows.shape)
    dev = rows.device
    status = torch.empty(k, dtype=torch.int32, device=dev)
    ticks = torch.empty((k, 2), dtype=torch.int64, device=dev)
    if k == 0:
        return status, ticks
    with torch.cuda.device(dev):
        err = lib.wt_xzdec(blob.data_ptr(), blob.numel(), desc.data_ptr(),
                           scratch.data_ptr(), scratch.numel(),
                           rows.data_ptr(), status.data_ptr(),
                           ticks.data_ptr(), k, X, Y, Z, _stream(rows))
        _raise_if(err, lib, "xzdec")
        launches["xzdec"] += 1
    return status, ticks
