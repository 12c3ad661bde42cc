"""COCO run-length encoding, wire-compatible with pycocotools.

A copy of mapping_tpu/ops/rle.py without its PIL dependency: Fortran-order
runs, the LEB128-style compressed `counts` strings, decode, area, bbox,
merge and IoU in numpy, with the C++ library (utils/native.py) as the fast
path where it builds. `from_polygons` rasterises with a numpy scanline
fill in place of PIL's ImageDraw.

All functions take and return {"size": [h, w], "counts": bytes|str} dicts.
"""

import numpy as np

from mapping_tpu_torch.utils import native as _native


# ---------------------------------------------------------------------------
# counts <-> compressed string (pycocotools rleToString / rleFrString)
# ---------------------------------------------------------------------------

def counts_to_string(counts):
    """Compress integer run lengths to the COCO `counts` byte string."""
    if _native.available():
        return _native.counts_to_string(counts)
    s = bytearray()
    counts = [int(c) for c in counts]
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(c + 48)
    return bytes(s)


def string_to_counts(s):
    """Decompress a COCO `counts` byte/str string to run lengths."""
    if isinstance(s, str):
        s = s.encode("ascii")
    if _native.available():
        return _native.string_to_counts(s)
    counts = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


# ---------------------------------------------------------------------------
# binary mask <-> RLE
# ---------------------------------------------------------------------------

def encode(mask):
    """Binary (H, W) mask -> compressed RLE dict
    (pycocotools.mask.encode of the Fortran-ordered mask)."""
    mask = np.asarray(mask)
    h, w = mask.shape
    flat = (mask != 0).flatten(order="F")
    return {"size": [int(h), int(w)],
            "counts": counts_to_string(_runs_from_flat(flat))}


def _runs_from_flat(flat):
    """Runs of a flat boolean array, starting with a (possibly 0-length) run
    of zeros."""
    n = flat.size
    if n == 0:
        return [0]
    change = np.nonzero(np.diff(flat))[0] + 1
    boundaries = np.concatenate([[0], change, [n]])
    runs = np.diff(boundaries).tolist()
    if flat[0]:
        runs = [0] + runs
    return runs


def _counts(rle):
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = string_to_counts(counts)
    return counts


def decode(rle):
    """Compressed or uncompressed RLE dict -> (H, W) uint8 mask."""
    h, w = rle["size"]
    counts = np.asarray(_counts(rle), dtype=np.int64)
    flat = np.zeros(h * w, dtype=np.uint8)
    ends = np.cumsum(counts)
    starts = ends - counts
    for i in range(1, len(counts), 2):
        flat[starts[i]:ends[i]] = 1
    return flat[:h * w].reshape((h, w), order="F")


def area(rle):
    return int(sum(_counts(rle)[1::2]))


def to_bbox(rle):
    """RLE -> [x, y, w, h] float bbox (pycocotools.mask.toBbox)."""
    h, w = rle["size"]
    counts = np.asarray(_counts(rle), dtype=np.int64)
    if counts[1::2].sum() == 0:
        return [0.0, 0.0, 0.0, 0.0]
    ends = np.cumsum(counts)
    starts = ends - counts
    nonzero = counts[1::2] > 0
    fg_starts = starts[1::2][nonzero]
    fg_ends = ends[1::2][nonzero] - 1
    # Fortran order: linear index = x * h + y
    xs0, ys0 = fg_starts // h, fg_starts % h
    xs1, ys1 = fg_ends // h, fg_ends % h
    if (xs1 > xs0).any():  # a run across columns covers whole rows
        y_min, y_max = 0, h - 1
    else:
        y_min, y_max = int(ys0.min()), int(ys1.max())
    x_min, x_max = int(xs0.min()), int(xs1.max())
    return [float(x_min), float(y_min), float(x_max - x_min + 1),
            float(y_max - y_min + 1)]


def merge(rles, intersect=False):
    """Union (or intersection) of several RLEs (pycocotools.mask.merge)."""
    if len(rles) == 0:
        raise ValueError("merge of zero RLEs")
    if len(rles) == 1:
        return dict(rles[0])
    out = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        m = decode(r).astype(bool)
        out = out & m if intersect else out | m
    return encode(out.astype(np.uint8))


def iou(dt_rles, gt_rles, iscrowd):
    """(len(dt), len(gt)) float64 IoU matrix (pycocotools.mask.iou): for
    a crowd GT the union is the detection's area."""
    if _native.available():
        return _native.rle_iou(dt_rles, gt_rles, iscrowd)
    if len(dt_rles) == 0 or len(gt_rles) == 0:
        return np.zeros((len(dt_rles), len(gt_rles)))
    dt_masks = np.stack([decode(r).reshape(-1)
                         for r in dt_rles]).astype(np.float32)
    gt_masks = np.stack([decode(r).reshape(-1)
                         for r in gt_rles]).astype(np.float32)
    inter = dt_masks @ gt_masks.T
    dt_areas = dt_masks.sum(axis=1)[:, None]
    gt_areas = gt_masks.sum(axis=1)[None, :]
    iscrowd = np.asarray(iscrowd, dtype=bool)[None, :]
    union = np.where(iscrowd, dt_areas, dt_areas + gt_areas - inter)
    return inter / np.maximum(union, 1e-9)


def iou_boxes(dt_boxes, gt_boxes, iscrowd):
    """Pairwise IoU between [x, y, w, h] boxes (pycocotools bbox mode)."""
    dt = np.asarray(dt_boxes, dtype=np.float64).reshape(-1, 4)
    gt = np.asarray(gt_boxes, dtype=np.float64).reshape(-1, 4)
    if dt.size == 0 or gt.size == 0:
        return np.zeros((dt.shape[0], gt.shape[0]))
    x1 = np.maximum(dt[:, None, 0], gt[None, :, 0])
    y1 = np.maximum(dt[:, None, 1], gt[None, :, 1])
    x2 = np.minimum(dt[:, None, 0] + dt[:, None, 2],
                    gt[None, :, 0] + gt[None, :, 2])
    y2 = np.minimum(dt[:, None, 1] + dt[:, None, 3],
                    gt[None, :, 1] + gt[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    dt_a = (dt[:, 2] * dt[:, 3])[:, None]
    gt_a = (gt[:, 2] * gt[:, 3])[None, :]
    iscrowd = np.asarray(iscrowd, dtype=bool)[None, :]
    union = np.where(iscrowd, dt_a, dt_a + gt_a - inter)
    return inter / np.maximum(union, 1e-9)


# ---------------------------------------------------------------------------
# polygons / uncompressed objects -> RLE (pycocotools frPyObjects)
# ---------------------------------------------------------------------------

def polygon_mask(poly, h, w):
    """Flat [x0, y0, x1, y1, ...] polygon -> (h, w) uint8 mask.

    The JAX package fills the polygon with PIL's ImageDraw.polygon on a 5x
    grid, vertex v at 5 v + 2, and samples each pixel at the centre of its
    5 x 5 cell, 5 i + 2. This evaluates PIL's scanline fill at those
    centres only: vertices truncated to integers on the 5x grid;
    horizontal edges drawn whole; on each other scan line the crossings of
    the edges whose y-range holds it (in float32, an edge's last row
    counted twice unless it is the polygon's last row), sorted, and each
    pair filled from its first crossing rounded half up to its second
    rounded half down. Pixel-exact with PIL on axis-aligned rectangles; on
    other polygons PIL's corner joins can set a few more boundary pixels."""
    pts = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
    mask = np.zeros((h, w), np.uint8)
    if len(pts) < 2:
        return mask
    v = np.trunc(pts * 5.0 + 2.0).astype(np.int64)
    # pixels whose sample point can be reached: the vertices' bbox
    r0, c0 = (max((v[:, i].min() - 2) // 5, 0) for i in (1, 0))
    r1 = min(-(-(v[:, 1].max() - 2) // 5), h - 1)
    c1 = min(-(-(v[:, 0].max() - 2) // 5), w - 1)
    if r1 < r0 or c1 < c0:
        return mask
    ys = (5 * np.arange(r0, r1 + 1) + 2)[:, None]
    xs = 5 * np.arange(c0, c1 + 1) + 2
    out = np.zeros((len(ys), len(xs)), bool)
    a, b = v, np.roll(v, -1, axis=0)
    flat = a[:, 1] == b[:, 1]
    for (xa, ya), (xb, _) in zip(a[flat], b[flat]):
        out[ys[:, 0] == ya] |= (xs >= min(xa, xb)) & (xs <= max(xa, xb))
    a, b = a[~flat], b[~flat]
    if len(a):
        lo = np.minimum(a[:, 1], b[:, 1])
        hi = np.maximum(a[:, 1], b[:, 1])
        dx = ((b[:, 0] - a[:, 0]).astype(np.float32)
              / (b[:, 1] - a[:, 1]).astype(np.float32))
        x = (ys - a[:, 1]).astype(np.float32) * dx \
            + a[:, 0].astype(np.float32)
        on = (ys >= lo) & (ys <= hi)
        twice = on & (ys == hi) & (ys < min(hi.max(), 5 * h))
        cross = np.sort(np.concatenate([np.where(on, x, np.inf),
                                        np.where(twice, x, np.inf)], 1), 1)
        for k in range(0, cross.shape[1] - 1, 2):
            xa, xb = cross[:, k:k + 1], cross[:, k + 1:k + 2]
            start, end = np.floor(xa + 0.5), np.ceil(xb - 0.5)
            ok = np.isfinite(xb) & (end >= xa)
            out |= ok & (xs >= start) & (xs <= end)
    mask[r0:r1 + 1, c0:c1 + 1] = out
    return mask


def from_polygons(polygons, h, w):
    """List of flat [x0, y0, x1, y1, ...] polygons -> list of RLE dicts."""
    return [encode(polygon_mask(poly, h, w)) for poly in polygons]


def from_py_objects(objs, h, w):
    """pycocotools.mask.frPyObjects for the shapes a COCO file holds."""
    if isinstance(objs, dict):
        counts = objs["counts"]
        if isinstance(counts, list):
            return {"size": objs["size"], "counts": counts_to_string(counts)}
        return dict(objs)
    if isinstance(objs, (list, tuple)):
        if len(objs) == 0:
            return []
        if isinstance(objs[0], (int, float)):  # one flat polygon
            return from_polygons([objs], h, w)
        if isinstance(objs[0], dict):
            return [from_py_objects(o, h, w) for o in objs]
        return from_polygons(objs, h, w)
    raise TypeError(f"unsupported object for RLE conversion: {type(objs)}")


def annotation_to_rle(ann, h, w):
    """COCO annotation dict -> one merged RLE (annToRLE)."""
    seg = ann["segmentation"]
    if isinstance(seg, dict):
        return from_py_objects(seg, h, w)
    rles = from_py_objects(seg, h, w)
    if isinstance(rles, dict):
        return rles
    return merge(rles)
