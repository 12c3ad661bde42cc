"""ctypes bindings to the C++ RLE library (cpp/rle.cpp).

Counterpart of mapping_tpu/utils/native.py: the COCO counts codec, the
run-space IoU of two RLEs (also over decoded `RleHandle`s, the scoring
NMS's inner loop) and the single-pass extraction of every instance's RLE
from a labelled map. The numpy code in ops/rle.py is the oracle and serves
the COCO evaluator where this library does not build; the scoring path
raises instead (scoring.py).
"""

import ctypes

import numpy as np

from mapping_tpu_torch.utils.native_lib import NativeLib


def _register(lib):
    lib.rle_counts_to_string.restype = ctypes.c_long
    lib.rle_counts_to_string.argtypes = [
        ctypes.POINTER(ctypes.c_long), ctypes.c_long, ctypes.c_char_p]
    lib.rle_string_to_counts.restype = ctypes.c_long
    lib.rle_string_to_counts.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    lib.rle_iou_single.restype = ctypes.c_double
    lib.rle_iou_single.argtypes = [
        ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.c_long, ctypes.c_int]
    lib.rle_instances.restype = ctypes.c_long
    lib.rle_instances.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_double)]


_lib = NativeLib("rle.cpp", "rle", _register)
load = _lib.load
available = _lib.available


def counts_to_string(counts):
    counts = [int(c) for c in counts]
    n = len(counts)
    arr = (ctypes.c_long * n)(*counts)
    buf = ctypes.create_string_buffer(n * 12 + 16)
    m = load().rle_counts_to_string(arr, n, buf)
    return buf.raw[:m]


def string_to_counts(s):
    n = len(s)
    out = (ctypes.c_long * (n + 1))()
    m = load().rle_string_to_counts(s, n, out)
    return [out[i] for i in range(m)]


def rle_instances(labels, n_instances):
    """Labelled int32 (H, W) map -> [(counts bytes, [x, y, w, h])] for
    labels 1..n_instances, in one C++ pass."""
    lib = load()
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    h, w = labels.shape
    cap = max(1 << 16, 24 * (h * w // 2 + n_instances * 8))
    # the C side checks capacity against 13 bytes per count, far above the
    # usual 1-2, so grow and retry up to the true worst case
    hard = 13 * (2 * h * w + 2 * n_instances) + 16 * (n_instances + 1)
    while True:
        buf = ctypes.create_string_buffer(cap)
        offsets = (ctypes.c_long * (n_instances + 1))()
        bbox = (ctypes.c_double * (n_instances * 4))()
        used = lib.rle_instances(
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            h, w, n_instances, buf, cap, offsets, bbox)
        if used >= 0:
            break
        if cap >= hard:
            raise MemoryError("rle_instances output buffer too small")
        cap = min(cap * 4, hard)
    return [(buf.raw[offsets[i]:offsets[i + 1]],
             [bbox[4 * i], bbox[4 * i + 1], bbox[4 * i + 2], bbox[4 * i + 3]])
            for i in range(n_instances)]


class RleHandle:
    """One RLE's counts decoded once into a ctypes array, for repeated
    rle_iou_pair calls; `area` is its foreground pixel count (the sum of
    the odd runs)."""

    __slots__ = ("arr", "n", "area")

    def __init__(self, counts_bytes):
        nb = len(counts_bytes)
        out = (ctypes.c_long * (nb + 1))()
        self.n = load().rle_string_to_counts(counts_bytes, nb, out)
        self.arr = out
        runs = np.frombuffer(out, dtype=np.dtype(ctypes.c_long),
                             count=self.n)
        self.area = int(runs[1::2].sum())


def rle_iou_pair(a: RleHandle, b: RleHandle) -> float:
    """Exact (non-crowd) IoU of two RleHandles."""
    return load().rle_iou_single(a.arr, a.n, b.arr, b.n, 0)


def rle_iou(dt_rles, gt_rles, iscrowd):
    """(len(dt), len(gt)) IoU matrix of RLE dicts; crowd GTs count the
    detection's area as the union."""
    lib = load()
    out = np.zeros((len(dt_rles), len(gt_rles)))
    if out.size == 0:
        return out

    def counts_of(r):
        c = r["counts"]
        if isinstance(c, (bytes, str)):
            c = string_to_counts(c.encode("ascii") if isinstance(c, str) else c)
        return (ctypes.c_long * len(c))(*[int(x) for x in c]), len(c)

    dts = [counts_of(r) for r in dt_rles]
    gts = [counts_of(r) for r in gt_rles]
    for i, (dc, dn) in enumerate(dts):
        for j, (gc, gn) in enumerate(gts):
            out[i, j] = lib.rle_iou_single(dc, dn, gc, gn,
                                           int(bool(iscrowd[j])))
    return out
