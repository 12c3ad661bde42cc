"""What a ZSTD frame holds, for the fixtures and their tests: the decoder
paths its blocks take (a plain reading of RFC 8878's headers; no
decoding)."""

import struct

#: a literals section's type -> its name
LITERALS = ("raw", "rle", "huffman", "treeless")
#: a sequence table's mode -> its name
MODES = ("predefined", "rle", "fse", "repeat")


def _literals(block):
    """(feature, bytes the literals section takes)."""
    kind, size_format = block[0] & 3, (block[0] >> 2) & 3
    if kind < 2:
        head = {0: 1, 2: 1, 1: 2, 3: 3}[size_format]
        size = int.from_bytes(block[:head], "little") >> (3 if head == 1
                                                         else 4)
        return f"literals_{LITERALS[kind]}", head + (size if kind == 0
                                                      else 1)
    head = {0: 3, 1: 3, 2: 4, 3: 5}[size_format]
    word = int.from_bytes(block[:5].ljust(5, b"\x00"), "little")
    bits = {3: 10, 4: 14, 5: 18}[head]
    size = (word >> 4) & ((1 << bits) - 1)
    csize = (word >> (4 + bits)) & ((1 << bits) - 1)
    streams = 1 if size_format == 0 else 4
    name = f"literals_{LITERALS[kind]}_{streams}_streams"
    if streams == 4 and kind == 2 and double_symbol(size, csize):
        name += "_double_symbol"
    return name, head + csize


def features(frame):
    """The set of paths the frames of `frame` (data and skippable ones in
    turn) take: block kinds, literals kinds and stream counts, the
    sequence tables' modes, the checksum, the window."""
    found = set()
    pos = 0
    while pos + 8 <= len(frame):
        magic = struct.unpack_from("<I", frame, pos)[0]
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            found.add("skippable_frame")
            pos += 8 + struct.unpack_from("<I", frame, pos + 4)[0]
            continue
        if magic != 0xFD2FB528:
            break
        fhd = frame[pos + 4]
        single = (fhd >> 5) & 1
        fcs_size = (0, 2, 4, 8)[fhd >> 6] or (1 if single else 0)
        at = pos + 5
        if not single:
            window = 1 << ((frame[at] >> 3) + 10)
            window += (window >> 3) * (frame[at] & 7)
            found.add("window_over_2^20" if window > 1 << 20
                      else "window_descriptor")
            at += 1
        else:
            found.add("single_segment")
        at += (0, 1, 2, 4)[fhd & 3] + fcs_size
        found.add("content_size" if fcs_size else "no_content_size")
        while True:
            head = int.from_bytes(frame[at:at + 3], "little")
            kind, size = (head >> 1) & 3, head >> 3
            at += 3
            body = frame[at:at + (1 if kind == 1 else size)]
            found.add(("raw_block", "rle_block", "compressed_block")[kind])
            if kind == 2:
                lit, used = _literals(body)
                found.add(lit)
                seq = body[used:]
                count = seq[0] if seq else 0
                if count:
                    step = 1 if count < 128 else 3 if count == 255 else 2
                    modes = seq[step]
                    for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
                        found.add(f"{name}_{MODES[(modes >> shift) & 3]}")
                else:
                    found.add("no_sequences")
            at += 1 if kind == 1 else size
            if head & 1:
                break
        if fhd & 4:
            found.add("checksum")
            at += 4
        pos = at
    return found


#: libzstd 1.5.7's HUF_selectDecoder timings: (table, decode per 256
#: bytes) of the single- and double-symbol decoders, by quantized ratio
_ALGO_TIME = ((0, 0, 1, 1), (0, 0, 1, 1), (150, 216, 381, 119),
              (170, 205, 514, 112), (177, 199, 539, 110),
              (197, 194, 644, 107), (221, 192, 735, 107),
              (256, 189, 881, 106), (359, 188, 1167, 109),
              (582, 187, 1570, 114), (688, 187, 1712, 122),
              (825, 186, 1965, 136), (976, 185, 2131, 150),
              (1180, 186, 2070, 175), (1377, 185, 1731, 202),
              (1412, 185, 1695, 202))


def double_symbol(size, csize):
    """Does libzstd decode a 4-stream Huffman literals section of `size`
    bytes from `csize` with its double-symbol decoder?"""
    q = 15 if csize >= size else csize * 16 // size
    t0, d0, t1, d1 = _ALGO_TIME[q]
    one, two = t0 + d0 * (size >> 8), t1 + d1 * (size >> 8)
    return two + (two >> 5) < one
