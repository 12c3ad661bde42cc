"""COCO annotations -> per-image training targets, computed on the device.

Counterpart of mapping_tpu/prep/targets.py (the reference's
src/preparation.py). Per image it derives
 - a class mask: the union of the annotation masks after the per-object
   rules, optionally with a border class;
 - a distance map: at each pixel the sum of the two smallest per-object
   Euclidean distances (written as float16);
 - a size matrix: each pixel's connected-component area, 1 on the
   background (int32).
The rules, in the reference's order: objects whose interior (the 2-pixel
frame excluded) is empty are dropped; objects larger than
`small_annotations_size`^2 pixels are eroded, and with `dilate` > 0 the
small ones are dilated, otherwise objects that erosion erased come back
un-eroded; the border class (mask.max() + 1) goes where the second-nearest
object is closer than `border_width`, outside the objects.

`prepare_batch` does all of it for a batch of images in one call on the
stack's device: (B, N, H, W) object masks and their (B, N) valid flags, the
objects' distances merged one slot at a time into a running top 2 (1e12
where there is none yet), and one `connected_components` call over the
(B, H, W) union masks, which on the card is the CUDA CCL kernel
`kernels.ccl.label`. The JAX package's per-image `_prepare_device` is this
function at B = 1. Its bit-packed transfer of the stack
(`pack_object_stack`) was a workaround for the TPU's host link and is not
ported: the stack goes to the card as bool.

`prepare_image_targets` pads one image's objects into a bucket of 8, 16,
32, 64 or MAX_OBJECTS = 128 slots; an image with more objects runs its
chunks of 128 in one call that returns each chunk's raw top 2, and the
chunks are merged with the global counts before the labelling.
`overlay_masks` writes the target files of a split, grouping images by
(size, bucket) into batches of {8: 16, 16: 16, 32: 8, 64: 4, 128: 2}.
"""

import os
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from mapping_tpu_torch.data.coco import COCOIndex
from mapping_tpu_torch.ops.ccl import connected_components
from mapping_tpu_torch.ops.edt import BIG, edt
from mapping_tpu_torch.ops.instance import size_matrix
from mapping_tpu_torch.ops.morphology import dilate as _dilate
from mapping_tpu_torch.ops.morphology import erode as _erode
from mapping_tpu_torch.utils import ndpickle
from mapping_tpu_torch.utils.png import write_png_gray

MAX_OBJECTS = 128


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("prepare_masks: CUDA device requested but "
                           "torch.cuda.is_available() is False")
    return device


def _pad_for(n: int) -> int:
    """The object-slot bucket of an image with n objects (at most
    MAX_OBJECTS, read at call time)."""
    return next(b for b in (8, 16, 32, 64, MAX_OBJECTS)
                if b >= min(n, MAX_OBJECTS))


def _interior_empty(stack):
    """(..., N, H, W) -> (..., N) True where the object lies only in the
    2-pixel frame (the reference's is_on_border)."""
    return ~stack[..., 2:-2, 2:-2].flatten(-2).any(-1)


def prepare_batch(stack, valid, erode_size=0, dilate_size=0,
                  small_annotations_size=14, border_width=0,
                  raw_top2=False):
    """Targets of a batch of images on the stack's device.

    Args:
        stack: (B, N, H, W) bool object masks.
        valid: (B, N) bool, which slots hold an object.

    Returns:
        (mask (B, H, W) uint8, distances (B, H, W) float32 (the sum of the
        two smallest), second (B, H, W) float32, sizes (B, H, W) int32).
        With `raw_top2` (the chunked path): (binary mask uint8, nearest,
        second, n_valid (B,)) without the clamps, the labelling or the
        border class, with 1e12 where fewer objects reached a pixel.
    """
    b, n, h, w = stack.shape
    flat = stack.flatten(2)
    valid = valid & ~_interior_empty(stack) & flat.any(-1)
    big = (flat.sum(-1) > small_annotations_size ** 2)[..., None, None]
    processed = stack
    if erode_size > 0:
        u8 = stack.reshape(b * n, h, w).to(torch.uint8)
        eroded = _erode(u8, erode_size).bool().reshape(b, n, h, w)
        if dilate_size > 0:
            dilated = _dilate(u8, dilate_size).bool().reshape(b, n, h, w)
            processed = torch.where(big, eroded, dilated)
        else:
            processed = torch.where(big, eroded, stack)
            # objects erosion erased come back (add_dropped_objects)
            erased = ~processed.flatten(2).any(-1)
            processed = torch.where((erased & valid)[..., None, None], stack,
                                    processed)
    processed = processed & valid[..., None, None]

    # the running top 2 over the object slots; a slot no image uses would
    # leave both maps as they are, so it is skipped
    nearest = torch.full((b, h, w), BIG, device=stack.device)
    second = torch.full((b, h, w), BIG, device=stack.device)
    used = valid.any(0).tolist()
    for j in range(n):
        if used[j]:
            d = torch.where(valid[:, j, None, None], edt(processed[:, j]), BIG)
            second = torch.minimum(second, torch.maximum(nearest, d))
            nearest = torch.minimum(nearest, d)
    n_valid = valid.sum(1)
    mask = processed.any(1)
    if raw_top2:
        return mask.to(torch.uint8), nearest, second, n_valid

    # the reference's clean_distances: no object -> zeros, one object ->
    # its distance twice
    count = n_valid[:, None, None]
    nearest = torch.where(count >= 1, nearest, 0.0)
    second = torch.where(count >= 2, second, nearest)
    labels = connected_components(mask)
    sizes = size_matrix(labels, MAX_OBJECTS)
    mask_out = mask.to(torch.uint8)
    if border_width > 0:
        borders = (second < border_width) & ~mask
        border_class = mask_out.amax(dim=(1, 2), keepdim=True) + 1
        mask_out = torch.where(borders, border_class, mask_out)
    return mask_out, nearest + second, second, sizes


def _stack_masks(masks_per_image, pad, size):
    """Host (B, pad, H, W) bool stack and (B, pad) valid flags of each
    image's first `pad` masks."""
    stack = np.zeros((len(masks_per_image), pad) + tuple(size), bool)
    valid = np.zeros(stack.shape[:2], bool)
    for i, masks in enumerate(masks_per_image):
        for j, m in enumerate(masks[:pad]):
            stack[i, j] = m
        valid[i, :min(len(masks), pad)] = True
    return stack, valid


def _merge_chunks(mask, nearest, second, n_valid, border_width):
    """The chunked path's merge: (C, H, W) raw maps of C chunks of one
    image -> (mask, distances, second, sizes) of the image, with the
    global valid count's clamps and sizes counted over every label."""
    mask = mask.amax(0).bool()
    cand = torch.sort(torch.cat([nearest, second]), dim=0).values
    nearest, second = cand[0], cand[1]
    n_valid = int(n_valid.sum())
    if n_valid < 1:
        nearest = torch.zeros_like(nearest)
    if n_valid < 2:
        second = nearest.clone()
    labels = connected_components(mask)
    counts = torch.bincount(labels.flatten().to(torch.int64))
    counts[0] = 1  # the background stays size 1, as size_matrix does
    sizes = counts[labels.to(torch.int64)].to(torch.int32)
    mask_out = mask.to(torch.uint8)
    if border_width > 0:
        borders = (second < border_width) & ~mask
        mask_out = torch.where(borders, mask_out.max() + 1, mask_out)
    return mask_out, nearest + second, second, sizes


def prepare_image_targets(annotation_masks: Sequence[np.ndarray], image_size,
                          erode: int = 0, dilate: int = 0,
                          small_annotations_size: int = 14,
                          border_width: int = 0, category_nr: int = 1,
                          device="cuda"):
    """Decoded annotation masks (list of (H, W) uint8) -> dict(mask uint8,
    distances float16, second float32, sizes int32) of numpy arrays, as
    the reference writes them per image (src/preparation.py:88-97).
    `category_nr` is accepted for the JAX signature and not read there
    either."""
    h, w = image_size
    n = len(annotation_masks)
    if n == 0:
        return {"mask": np.zeros((h, w), np.uint8),
                "distances": np.zeros((h, w), np.float16),
                "second": np.zeros((h, w), np.float32),
                "sizes": np.ones((h, w), np.int32)}
    device = _device(device)
    pad = _pad_for(n)
    chunks = [annotation_masks[i:i + pad] for i in range(0, n, pad)]
    stack, valid = _stack_masks(chunks, pad, (h, w))
    stack = torch.from_numpy(stack).to(device)
    valid = torch.from_numpy(valid).to(device)
    args = (erode, dilate, small_annotations_size)
    if len(chunks) > 1:
        # more objects than MAX_OBJECTS (rare): raw per-chunk top 2 maps,
        # merged here; per-chunk clamps or borders would poison the merge
        out = _merge_chunks(*prepare_batch(stack, valid, *args, 0,
                                           raw_top2=True), border_width)
    else:
        out = [t[0] for t in prepare_batch(stack, valid, *args,
                                           border_width)]
    mask, dist, second, sizes = out
    return {"mask": mask.cpu().numpy(),
            "distances": dist.to(torch.float16).cpu().numpy(),
            "second": second.cpu().numpy(),
            "sizes": sizes.to(torch.int32).cpu().numpy()}


def _shift_category(mask, category_nr):
    """Device classes {0, 1 = object, 2 = border} -> {0, category_nr,
    category_nr + 1}: nonzero values shift, so the border class stays
    apart from the objects."""
    return np.where(mask > 0, mask + (category_nr - 1), 0).astype(np.uint8)


def write_artifacts(target_dir, dataset, stem, mask, dist, sizes):
    """{target_dir}/{dataset}/masks/{stem}.png (8-bit grey), and the
    float16 distances and int32 sizes as pickles under distances/ and
    sizes/ (no extension), the layout of src/preparation.py:88-92."""
    write_png_gray(os.path.join(target_dir, dataset, "masks", stem + ".png"),
                   np.asarray(mask, np.uint8))
    ndpickle.dump(np.asarray(dist, np.float16),
                  os.path.join(target_dir, dataset, "distances", stem))
    ndpickle.dump(np.asarray(sizes, np.int32),
                  os.path.join(target_dir, dataset, "sizes", stem))


def overlay_masks(data_dir: str, dataset: str, target_dir: str,
                  category_ids: Sequence[Optional[int]], erode: int = 0,
                  dilate: int = 0, is_small: bool = False,
                  num_threads: int = 1, border_width: int = 0,
                  small_annotations_size: int = 14, device="cuda"):
    """The mask, distance and size files of every image of a split, from
    {data_dir}/{dataset}/annotation[-small].json, under
    {target_dir}/{dataset}/{masks,distances,sizes}/, computed on
    `device`."""
    if erode < 0 or dilate < 0:
        raise ValueError("erode and dilate cannot be negative")
    device = _device(device)
    suffix = "-small" if is_small else ""
    coco = COCOIndex(os.path.join(data_dir, dataset,
                                  f"annotation{suffix}.json"))
    for sub in ("masks", "distances", "sizes"):
        os.makedirs(os.path.join(target_dir, dataset, sub), exist_ok=True)
    real_cats = [(nr, cid) for nr, cid in enumerate(category_ids)
                 if cid is not None]
    rules = dict(erode=erode, dilate=dilate,
                 small_annotations_size=small_annotations_size, device=device)

    def stem_of(image):
        return os.path.splitext(image["file_name"])[0]

    def write(stem, mask, dist, sizes):
        write_artifacts(target_dir, dataset, stem, mask, dist, sizes)

    if len(real_cats) != 1:
        # several categories (not the CrowdAI layout), image by image: later
        # categories win where masks overlap, the distances and sizes are
        # taken over the objects of every category, and the border class is
        # set once, on the final mask (src/preparation.py:44-87)
        for image_id in coco.get_img_ids():
            image = coco.load_imgs([image_id])[0]
            size = (image["height"], image["width"])
            mask_total = np.zeros(size, np.uint8)
            union = []
            for category_nr, category_id in real_cats:
                masks = [coco.ann_to_mask(a) for a in coco.load_anns(
                    coco.get_ann_ids(img_ids=[image_id],
                                     cat_ids=[category_id]))]
                union.extend(masks)
                if masks:
                    cat = prepare_image_targets(masks, size, **rules)
                    mask_total = np.where(cat["mask"] > 0,
                                          np.uint8(category_nr), mask_total)
            targets = prepare_image_targets(union, size, **rules)
            if border_width > 0:
                borders = (targets["second"] < border_width) & (mask_total
                                                                == 0)
                mask_total = np.where(borders, mask_total.max() + 1,
                                      mask_total).astype(np.uint8)
            write(stem_of(image), mask_total, targets["distances"],
                  targets["sizes"])
        return

    category_nr, category_id = real_cats[0]
    batch_for_pad = {8: 16, 16: 16, 32: 8, 64: 4, MAX_OBJECTS: 2}
    pending = defaultdict(list)
    writes = deque()
    threads = max(int(num_threads), 2)
    lookahead = 4 * threads

    def decode(image_id):
        image = coco.load_imgs([image_id])[0]
        masks = [coco.ann_to_mask(a).astype(bool) for a in coco.load_anns(
            coco.get_ann_ids(img_ids=[image_id], cat_ids=[category_id]))]
        return image, (image["height"], image["width"]), masks

    def drain_writes(limit):
        # raise the writers' errors and bound the arrays they hold
        while writes and (writes[0].done() or len(writes) > limit):
            writes.popleft().result()

    def flush(bucket):
        items = pending.pop(bucket)
        size, pad = bucket
        stack, valid = _stack_masks([masks for _, _, masks in items], pad,
                                    size)
        mask_b, dist_b, _, sizes_b = prepare_batch(
            torch.from_numpy(stack).to(device),
            torch.from_numpy(valid).to(device), erode, dilate,
            small_annotations_size, border_width)
        mask_b = _shift_category(mask_b.cpu().numpy(), category_nr)
        dist_b = dist_b.to(torch.float16).cpu().numpy()
        sizes_b = sizes_b.cpu().numpy()
        for i, (image, _, _) in enumerate(items):
            writes.append(pool.submit(write, stem_of(image), mask_b[i],
                                      dist_b[i], sizes_b[i]))

    with ThreadPoolExecutor(threads) as pool:
        # a bounded window of decodes in flight, so that writes interleave
        # with them on the pool and decoded masks do not pile up
        ids = iter(coco.get_img_ids())
        inflight = deque()

        def submit_decodes():
            while len(inflight) < lookahead:
                image_id = next(ids, None)
                if image_id is None:
                    return
                inflight.append(pool.submit(decode, image_id))

        submit_decodes()
        while inflight:
            image, size, masks = inflight.popleft().result()
            submit_decodes()
            drain_writes(lookahead)
            n = len(masks)
            if n == 0:
                writes.append(pool.submit(
                    write, stem_of(image), np.zeros(size, np.uint8),
                    np.zeros(size, np.float16), np.ones(size, np.int32)))
            elif n > MAX_OBJECTS:
                targets = prepare_image_targets(
                    masks, size, border_width=border_width, **rules)
                writes.append(pool.submit(
                    write, stem_of(image),
                    _shift_category(targets["mask"], category_nr),
                    targets["distances"], targets["sizes"]))
            else:
                bucket = (size, _pad_for(n))
                pending[bucket].append((image, size, masks))
                if len(pending[bucket]) >= batch_for_pad[bucket[1]]:
                    flush(bucket)
        for bucket in list(pending):
            flush(bucket)
        drain_writes(0)
