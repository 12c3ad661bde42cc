"""The tiled CCL labelling of csrc/ccl.cu, emulated in numpy on the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them against
the plain versions and scipy there). Here the algorithm they run is
emulated step by step with the grids of `kernels.ccl.label_plan`: the
tile pass (runs as stars, unions of vertical run overlaps inside the tile,
each pixel's parent its tile root), the border pass (one thread per pixel
of each tile's top row and left column, in the plan's order) and the
resolve, with and without the renumbering's root count fused in. The
emulation must equal the plain `_label_raw` / `_renumber` exactly; the
plan must cover every pixel and every 4-neighbour pair once.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import ndimage

from mapping_tpu_torch.kernels import ccl as K
from mapping_tpu_torch.kernels.build import CSRC
from mapping_tpu_torch.ops.ccl import _label_raw, _renumber
from test_torch_ccl import CASES, _chunk_scratch, _kernel_rank_formula

PLAN_SHAPES = [(1, 16, 16), (20, 300, 300), (2, 304, 304), (3, 40, 57),
               (2, 120, 333), (1, 3, 70000)]


def _border_cases():
    """Masks whose components cross the tiles' borders (300^2 images)."""
    th, tw, size = K.TILE_H, K.TILE_W, 300
    grid = np.zeros((3, size, size), bool)
    grid[0, ::th] = grid[0, :, ::tw] = True  # the tiles' first row, column
    grid[1, th - 1::th] = grid[1, :, tw - 1::tw] = True  # their last ones
    grid[2] = grid[0] | grid[1]  # both sides of every border
    corners = np.zeros((3, size, size), bool)
    for y0 in range(th, size, th):
        for x0 in range(tw, size, tw):
            corners[0, y0 - 1:y0 + 1, x0 - 1:x0 + 1] = True  # a 2x2 square
            ring = corners[1, y0 - 3:y0 + 3, x0 - 3:x0 + 3]
            ring[:] = True
            ring[1:-1, 1:-1] = False  # a ring through all four tiles
            for i in range(4):  # a staircase from the upper left tile down
                corners[2, y0 - 2 + i, x0 - 2 + i:x0 + i] = True
    snake = np.zeros((1, size, size), bool)
    snake[0, ::2] = True  # one path: rows joined at alternate ends
    snake[0, 1::4, -1] = True
    snake[0, 3::4, 0] = True
    return {"tile_grid": grid, "tile_corners": corners, "snake": snake}


BORDER_CASES = _border_cases()


def _find(tree, x):
    while tree[x] != x:
        x = tree[x]
    return x


def _unite(tree, a, b):
    """The lock-free union run one at a time: the larger root hangs under
    the smaller, so a root is its tree's minimal index."""
    a, b = _find(tree, a), _find(tree, b)
    if a != b:
        tree[max(a, b)] = min(a, b)


def _roots(tree, idx):
    """Root of each index in `idx` (every link points to a smaller index)."""
    out = tree[idx]
    while True:
        nxt = tree[out]
        if np.array_equal(nxt, out):
            return out
        out = nxt


def _tile_pass(img, y0, x0, parent):
    """tile_label on one tile of `img` (H, W) bool: writes each foreground
    pixel's tile root, as an image index, into `parent`."""
    h, w = img.shape
    th, tw = K.TILE_H, K.TILE_W
    sub = np.zeros((th, tw), bool)  # pixels outside the image: background
    part = img[y0:y0 + th, x0:x0 + tw]
    sub[:part.shape[0], :part.shape[1]] = part
    # every pixel points at the pixel after the last background pixel left
    # of it (its run's first pixel, where it is foreground)
    xs = np.where(~sub, np.arange(tw), -1)
    last_bg = np.maximum.accumulate(xs, axis=1)
    left_bg = np.concatenate([np.full((th, 1), -1), last_bg[:, :-1]], 1)
    tree = (np.arange(th)[:, None] * tw + left_bg + 1).ravel()
    overlap = sub[1:] & sub[:-1]
    starts = overlap & ~np.pad(overlap, ((0, 0), (1, 0)))[:, :-1]
    for r, x in zip(*np.nonzero(starts)):
        _unite(tree, (r + 1) * tw + x, r * tw + x)
    fg = np.flatnonzero(sub)
    root = _roots(tree, fg)
    r, x = fg // tw, fg % tw
    parent[(y0 + r) * w + x0 + x] = (y0 + root // tw) * w + x0 + root % tw


def _border_pair(plan, t, k, h, w):
    """The pair (pixel in tile t, its neighbour across the border) of
    border thread k, or None where the thread has none; and the offset of
    the previous pair along the border (0 for the first)."""
    y0, x0 = (t // plan.tiles_x) * K.TILE_H, (t % plan.tiles_x) * K.TILE_W
    if k < K.TILE_W:
        x = x0 + k
        if y0 == 0 or x >= w:
            return None
        return y0 * w + x, y0 * w + x - w, 1 if k > 0 else 0
    y = y0 + k - K.TILE_W
    if x0 == 0 or y >= h:
        return None
    return y * w + x0, y * w + x0 - 1, w if k > K.TILE_W else 0


def _tiled_forest(m):
    """(N, H, W) bool -> (N, H * W) parents after the tile and border
    passes (background entries -1)."""
    n, h, w = m.shape
    plan = K.label_plan(n, h, w)
    parent = np.full((n, h * w), -1, np.int64)
    for b in range(n):
        for t in range(plan.tiles):
            _tile_pass(m[b], (t // plan.tiles_x) * K.TILE_H,
                       (t % plan.tiles_x) * K.TILE_W, parent[b])
        flat = m[b].ravel()
        for t in range(plan.tiles):
            for k in range(plan.border):
                pair = _border_pair(plan, t, k, h, w)
                if pair is None:
                    continue
                p, q, step = pair
                if not (flat[p] and flat[q]):
                    continue
                if step and flat[p - step] and flat[q - step]:
                    continue
                _unite(parent[b], p, q)
    return parent


def _resolve(m, parent):
    """resolve: 1 + each foreground pixel's root, background 0."""
    n, h, w = m.shape
    out = np.zeros((n, h * w), np.int64)
    for b in range(n):
        fg = np.flatnonzero(m[b])
        out[b, fg] = _roots(parent[b], fg) + 1
    return out.reshape(n, h, w)


def _fused_scratch(m, parent, chunk):
    """What resolve<kCount> writes besides the labels, over its grid of
    chunk x image: root bits (a pixel whose root is itself), roots in
    earlier words of the chunk, roots per chunk."""
    n, h, w = m.shape
    hw = h * w
    words, chunks = -(-hw // 32), -(-hw // chunk)
    per_chunk = chunk // 32
    bits = np.zeros((n, chunks * per_chunk, 32), bool)
    for b in range(n):
        fg = np.flatnonzero(m[b])
        is_root = np.zeros(chunks * chunk, bool)
        is_root[fg] = _roots(parent[b], fg) == fg
        bits[b] = is_root.reshape(-1, 32)
    counts = bits.sum(-1).reshape(n, chunks, per_chunk)
    word_before = (np.cumsum(counts, -1) - counts).reshape(n, -1)
    return bits[:, :words], word_before[:, :words], counts.sum(-1)


def _random_mask(shape):
    return np.random.RandomState(sum(shape)).rand(*shape) > 0.5


TILED_CASES = {**CASES, **BORDER_CASES,
               **{f"plan{s}": _random_mask(s) for s in PLAN_SHAPES}}


@pytest.mark.parametrize("name", sorted(TILED_CASES))
def test_tiled_labelling_matches_plain(name):
    """Tile pass, border pass and resolve, emulated with the plan's grids,
    give the plain `_label_raw` labels exactly; the fused resolve's
    scratch is count_roots' on those labels, and its ranks `_renumber`'s."""
    m = TILED_CASES[name]
    n, h, w = m.shape
    parent = _tiled_forest(m)
    raw = _resolve(m, parent)
    plain = _label_raw(torch.from_numpy(m), h + w).numpy()
    np.testing.assert_array_equal(raw, plain)
    fused = _fused_scratch(m, parent, K.CHUNK)
    for got, want in zip(fused, _chunk_scratch(plain, K.CHUNK)):
        np.testing.assert_array_equal(got, want)
    ranks = _kernel_rank_formula(plain, K.CHUNK, scratch=fused)
    np.testing.assert_array_equal(
        ranks, _renumber(torch.from_numpy(plain)).numpy())
    if name in BORDER_CASES:
        for b in range(n):
            np.testing.assert_array_equal(ranks[b], ndimage.label(m[b])[0])


def test_border_cases_cross_the_tiles():
    """The border cases are what they claim: on the grid every border pair
    is foreground on both sides in image 2, the corner shapes are one
    component per corner spanning four tiles, the snake is one component."""
    grid, corners, snake = (BORDER_CASES[k] for k in
                            ("tile_grid", "tile_corners", "snake"))
    assert ndimage.label(grid[2])[1] == 1
    assert (grid[2, K.TILE_H::K.TILE_H] & grid[2, K.TILE_H - 1:-1:K.TILE_H]
            ).all()
    n_corners = len(range(K.TILE_H, 300, K.TILE_H)) * len(
        range(K.TILE_W, 300, K.TILE_W))
    y0, x0 = K.TILE_H, K.TILE_W  # the first corner
    for b, tiles in ((0, 4), (1, 4), (2, 3)):
        labels, count = ndimage.label(corners[b])
        assert count == n_corners
        window = labels[y0 - 3:y0 + 3, x0 - 3:x0 + 3]
        first = window[window > 0][0]
        assert first > 0 and sum(
            bool((part == first).any()) for part in (
                window[:3, :3], window[:3, 3:], window[3:, :3],
                window[3:, 3:])) == tiles
    assert ndimage.label(snake[0])[1] == 1


def _source_constant(name):
    text = (CSRC / "ccl.cu").read_text()
    return int(re.search(rf"\b{name} = (\d+)", text).group(1))


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_label_plan_covers_pixels_and_neighbour_pairs_once(shape):
    """The tiles cover every pixel exactly once; every 4-neighbour pair
    lies inside one tile or is visited by exactly one border thread, and
    no border thread visits a pair inside a tile; a tile block's shared
    memory fits the 48 KB of static shared memory; the plan's constants
    are the kernel's."""
    n, h, w = shape
    plan = K.label_plan(n, h, w)
    assert (K.TILE_H, K.TILE_W, K.CHUNK) == tuple(
        _source_constant(c) for c in ("kTileH", "kTileW", "kChunk"))
    assert plan.tiles == plan.tiles_y * plan.tiles_x
    assert plan.border == K.TILE_H + K.TILE_W
    tile_of = np.full((h, w), -1, np.int64)
    covered = np.zeros((h, w), np.int64)
    for t in range(plan.tiles):
        y0, x0 = (t // plan.tiles_x) * K.TILE_H, (t % plan.tiles_x) * K.TILE_W
        assert y0 < h and x0 < w  # no tile lies wholly outside the image
        covered[y0:y0 + K.TILE_H, x0:x0 + K.TILE_W] += 1
        tile_of[y0:y0 + K.TILE_H, x0:x0 + K.TILE_W] = t
    assert (covered == 1).all()

    visits = {}
    for t in range(plan.tiles):
        for k in range(plan.border):
            pair = _border_pair(plan, t, k, h, w)
            if pair is not None:
                key = (min(pair[:2]), max(pair[:2]))
                visits[key] = visits.get(key, 0) + 1
    assert set(visits.values()) <= {1}
    flat_tile = tile_of.ravel()
    idx = np.arange(h * w).reshape(h, w)
    pairs = np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
        np.stack([idx[:-1].ravel(), idx[1:].ravel()], 1)])
    inside = flat_tile[pairs[:, 0]] == flat_tile[pairs[:, 1]]
    visited = np.array([(int(a), int(b)) in visits for a, b in pairs], bool)
    assert (inside ^ visited).all()
    assert len(visits) == int(visited.sum())
    assert plan.shared_bytes <= 48 * 1024
    assert plan.work == 2 * n * h * w + K.renumber_plan(n, h, w)[2]


@pytest.mark.parametrize("kernel", ["ccl", "conv_dw"])
def test_kernel_variants_patch_their_source(kernel):
    """Every replacement of tools/<kernel>_variants.json finds its string
    in the kernel's source, and every variant but the first changes it."""
    import json

    from mapping_tpu_torch.tools import kernel_variants as kv

    path = Path(kv.__file__).with_name(f"{kernel}_variants.json")
    variants = json.loads(path.read_text())
    texts = kv.patched_sources(kernel, variants)
    source = kv.SOURCES[kernel].read_text()
    first, *rest = variants
    assert texts[first] == source
    assert all(texts[name] != source for name in rest)
