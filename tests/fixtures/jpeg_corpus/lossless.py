"""A small lossless JPEG (SOF3) writer for fixtures and tests: the kinds
libjpeg-turbo's compressor does not write (subsampled components, scans of
any grouping, restart intervals in MCUs, component ids and markers of
one's own, other precisions and frame types for the refused kinds), in
plain Python and numpy. The samples are predicted as libjpeg-turbo 3.1's
decompressor undifferences them (jdlossls.c, jddiffct.c), so a file
decodes to the planes it was given (shifted right by the point transform
and back).

    encode(planes, factors, psv=1, pt=0, ...) -> bytes

`planes` are the components' sample arrays at their own sizes (ceil(H h /
hmax) x ceil(W v / vmax)); `factors` their (h, v) sampling factors.
"""

import struct

import numpy as np

#: a DC table of the 17 difference categories: 0 in 2 bits, 1-5 in 3, then
#: one category a length up to 14 bits
BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0)
VALUES = tuple(range(17))


def segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _codes(bits, values):
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = self.n = 0

    def put(self, value, n):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self):  # pad with 1-bits
        while self.n:
            self.put(1, 1)


def _predict(psv, ra, rb, rc):
    return (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
            rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv - 1]


def _differences(p, psv, precision, pt, reset_rows):
    """The differences that undifference to `p` (samples >> pt): the
    first row and every row in `reset_rows` from 2^(P - pt - 1), then
    the left neighbour; a later row's first sample from the one above."""
    d = np.zeros(p.shape, np.int64)
    for y in range(p.shape[0]):
        for x in range(p.shape[1]):
            if y == 0 or y in reset_rows:
                pred = 1 << (precision - pt - 1) if x == 0 else p[y, x - 1]
            elif x == 0:
                pred = p[y - 1, 0]
            else:
                pred = _predict(psv, int(p[y, x - 1]), int(p[y - 1, x]),
                                int(p[y - 1, x - 1]))
            d[y, x] = (int(p[y, x]) - pred) % 65536
    return d


def encode(planes, factors, psv=1, pt=0, *, ids=None, scans=None,
           restart=0, markers=b"", height=None, width=None, precision=8,
           sof=0xC3, scan_params=None, bits=BITS, values=VALUES):
    """A lossless JPEG of `planes`: SOI, `markers`, one DC table (0), the
    frame (`sof`, `precision`), and one scan per entry of `scans` (lists
    of component indices; one interleaved scan of all by default) with
    predictor `psv` and point transform `pt` (`scan_params` (Ss, Se,
    Ah << 4 | Al) bytes in their place), then EOI. `restart` is the
    restart interval in MCUs (0: none), or one a scan, each in a DRI
    segment before the scan where it changes."""
    n = len(planes)
    ids = list(ids or range(1, n + 1))
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    height = height or max(p.shape[0] * vmax // v
                           for p, (_, v) in zip(planes, factors))
    width = width or max(p.shape[1] * hmax // h
                         for p, (h, _) in zip(planes, factors))
    code = _codes(bits, values)
    out = bytearray(b"\xff\xd8" + markers)
    out += segment(0xC4, bytes([0]) + bytes(bits) + bytes(values))
    frame = struct.pack(">BHHB", precision, height, width, n)
    for ident, (h, v) in zip(ids, factors):
        frame += bytes([ident, (h << 4) | v, 0])
    out += segment(sof, frame)
    scans = scans or [list(range(n))]
    restarts = list(restart) if isinstance(restart, (list, tuple)) \
        else [restart] * len(scans)
    imcu_rows = -(-height // vmax)
    for k, scan in enumerate(scans):
        restart = restarts[k]
        if restart != (restarts[k - 1] if k else 0):
            out += segment(0xDD, struct.pack(">H", restart))
        head = bytes([len(scan)])
        for ci in scan:
            head += bytes([ids[ci], 0])
        out += segment(0xDA, head + (scan_params or bytes([psv, 0, pt])))
        interleaved = len(scan) > 1
        if interleaved:
            mcus_x, mcu_rows = -(-width // hmax), imcu_rows
        else:
            mcus_x, mcu_rows = planes[scan[0]].shape[1], \
                planes[scan[0]].shape[0]
        # a restart resets the predictors of the iMCU row it falls in
        resets = set()
        if restart and restart % mcus_x == 0:
            every = restart // mcus_x
            for row in range(every, mcu_rows, every):
                for ci in scan:
                    v = factors[ci][1]
                    resets.add((ci, (row if interleaved else row // v) * v))
        diffs = {ci: _differences(
            np.asarray(planes[ci], np.int64) >> pt, psv, precision, pt,
            {r for c, r in resets if c == ci}) for ci in scan}
        w = _Bits()
        rst = count = 0
        for my in range(mcu_rows):
            for mx in range(mcus_x):
                if restart and count == restart:
                    w.flush()
                    w.out += bytes([0xFF, 0xD0 + rst])
                    rst, count = (rst + 1) & 7, 0
                count += 1
                for ci in scan:
                    h, v = factors[ci] if interleaved else (1, 1)
                    d = diffs[ci]
                    for yy in range(v):
                        for xx in range(h):
                            y, x = my * v + yy, mx * h + xx
                            val = int(d[y, x]) if y < d.shape[0] \
                                and x < d.shape[1] else 0
                            val = val - 65536 if val > 32768 else val
                            s = 16 if val == 32768 else abs(val).bit_length()
                            w.put(*code[s])
                            if 0 < s < 16:
                                w.put(val if val > 0 else val - 1 + (1 << s),
                                      s)
        w.flush()
        out += w.out
    return bytes(out + b"\xff\xd9")
