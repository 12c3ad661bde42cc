"""Host decode, batch preprocessing on the device, and the batch flows.

Counterpart of mapping_tpu/data/loader.py:
- decode: `load_image` (a JPEG/PNG tile to a host array) and
  `load_target` (a mask PNG and its distance and size pickles); a file
  batch's images go through `utils/native_decode` (`_assemble`): the host
  half (a JPEG's Huffman decode) on a thread pool where the decoder
  releases the GIL, then one JPEG pixel-stage call a geometry straight
  onto the loader's device (the CUDA kernel `jpeg_pixels` on a card, on
  the loader's own stream, the consumer waiting on an event recorded
  after it), with the next batches decoded on a worker thread while the
  device runs (`_Prefetcher`);
- the device preprocess of both loader modes: `infer_batch_resize`
  (`_infer_batch_resize`), `infer_batch_pad` (`_infer_batch_pad`, the
  `crop_and_pad` mode), `train_batch_resize`, `train_batch_crop`,
  `eval_batch_resize` and `_resize_target`;
- `SegmentationLoader.transform`: the training flow over image and mask
  files (a new order each epoch from np.random.RandomState(seed), as in
  the JAX package, the next epoch's decode started as the last batch of
  one is handed out), validation flows with targets (ragged last batch),
  and inference flows (the ragged tail padded with duplicates of the last
  image, `n_images` the real count); `array_flow` serves tiles already in
  host memory;
- `in_memory_train_flow`, the `(flow, steps)` contract of `_train_gen`
  for tiles and targets already in host memory.
Targets are (B, H, W, 3) [mask, distance, sqrt(size)], uint16 on the host
(the JAX loader's format), cast to float32 on the device. The random
draws (augmentation, crops) come from a host torch.Generator seeded with
`seed`. A batch of tiles of mixed sizes is resized on the host to `size`,
as the JAX loader does through Pillow: the images by Pillow's bilinear
(`utils/resize.resize_bilinear_u8`, in `native_decode.assemble`), the
targets per channel in float32, nearest for the mask and size channels
and bilinear for the distance (`resize_nearest_f32`,
`resize_bilinear_f32`); such a batch's targets
are float32, a batch of one size keeps uint16.

Data parallel (`shard` = (rank, world) on the loader or the in-memory
flow, set by the pipeline of a rank): a training flow hands each rank its
contiguous slice of the global batch that the single-process flow makes
at that step, from the same shuffle, and the augmentation (and crop)
parameters are drawn for the whole global batch from the same host
generator, each rank applying its rows; only the rank's files are
decoded. The ranks' batches then concatenate to the single-process batch.
A global batch that does not divide over the ranks raises when the flow
is made, as the JAX package's batch sharding raises. Validation and
inference flows are not sharded.
"""

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from mapping_tpu_torch.data.augment import (PAD_FUNCTION, apply_fast_augment,
                                            center_crop, normalize_image,
                                            pad_fixed, random_crop,
                                            resize_bilinear, resize_nearest,
                                            sample_fast_augment,
                                            sample_random_crop)
from mapping_tpu_torch.utils import native_decode, ndpickle, png
from mapping_tpu_torch.utils.resize import (resize_bilinear_f32,
                                            resize_nearest_f32)


def load_image(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG or PNG file (utils/native_decode)."""
    return native_decode.decode_rgb(path)


def load_target(mask_path) -> np.ndarray:
    """A mask PNG and its distance and size files -> (H, W, 3) uint16
    [mask, distance, sqrt(size)].

    The paths follow the reference (src/loaders.py:140-153): /masks/ ->
    /distances/ (extension dropped) -> /sizes/. The distances are
    truncated to uint16 and the sizes are uint16 -> sqrt -> uint16; a
    missing distance file gives zeros, a missing size file ones."""
    mask = png.read_png_gray(mask_path).astype(np.uint16)
    distance_path = os.path.splitext(mask_path.replace("/masks/",
                                                       "/distances/"))[0]
    size_path = distance_path.replace("/distances/", "/sizes/")
    if os.path.exists(distance_path):
        dist = ndpickle.load(distance_path).astype(np.uint16)
    else:
        dist = np.zeros_like(mask)
    if os.path.exists(size_path):
        sizes = np.sqrt(ndpickle.load(size_path).astype(np.uint16)).astype(
            np.uint16)
    else:
        sizes = np.ones_like(mask)
    return np.stack([mask, dist, sizes], axis=-1)


def infer_batch_resize(image_u8: torch.Tensor, size: Tuple[int, int]):
    """(B, H, W, 3) uint8 -> (B, size[0], size[1], 3) float32: /255, bilinear
    resize to `size`, ImageNet normalisation; on the input's device."""
    img = resize_bilinear(image_u8.to(torch.float32) / 255.0, size)
    return normalize_image(img)


def infer_batch_pad(image_u8: torch.Tensor, pad: Tuple[int, int],
                    method: str = "replicate"):
    """(B, H, W, 3) uint8 -> (B, H + 2 h_pad, W + 2 w_pad, 3) float32:
    /255, `pad_fixed` by `method`, ImageNet normalisation."""
    return normalize_image(pad_fixed(image_u8.to(torch.float32) / 255.0,
                                     pad, method))


def resize_target_f32(target: np.ndarray, size: Tuple[int, int]
                      ) -> np.ndarray:
    """(H, W, C) target -> (size, C) float32 on the host, channel by
    channel as Pillow's mode "F" resizes it in the JAX loader: nearest for
    the mask (0) and the size (2 and on), bilinear for the distance (1)."""
    return np.dstack([
        (resize_bilinear_f32 if c == 1 else resize_nearest_f32)(
            target[..., c].astype(np.float32), size)
        for c in range(target.shape[-1])])


def _resize_target(target, size: Tuple[int, int]):
    """[mask, distance, size] float targets -> `size`: nearest for the mask
    and size channels, bilinear for the distance."""
    near = resize_nearest(target[..., [0, 2]], size)
    lin = resize_bilinear(target[..., 1:2], size)
    return torch.cat([near[..., :1], lin, near[..., 1:]], dim=-1)


def rank_rows(idx, shard):
    """The rows of a global batch `idx` that rank `shard[0]` of
    `shard[1]` takes: a contiguous equal slice (all of it without a
    shard); a batch that does not divide raises."""
    if shard is None:
        return idx
    rank, world = shard
    if len(idx) % world:
        raise ValueError(f"a batch of {len(idx)} does not divide over "
                         f"{world} ranks")
    b = len(idx) // world
    return idx[rank * b:(rank + 1) * b]


def _check_divides(n, batch_size, shard):
    """Every batch of a pass over n items (the last one ragged) must
    divide over the ranks."""
    if shard is not None and n:
        for b in {batch_size, n - (-(-n // batch_size) - 1) * batch_size}:
            rank_rows(range(b), shard)


def _global_draws(sample, b, shard, *args):
    """sample(n, *args, generator) for the global batch of a rank's `b`
    images, cut to the rank's rows: every rank consumes the generator as
    the single-process flow does."""
    world = 1 if shard is None else shard[1]
    draws = sample(b * world, *args)
    if isinstance(draws, dict):
        return {k: rank_rows(v, shard) for k, v in draws.items()}
    return tuple(rank_rows(v, shard) for v in draws)


def train_batch_resize(generator: Optional[torch.Generator], image_u8,
                       target, size: Tuple[int, int], augment: bool = True,
                       shard=None):
    """A training batch on the inputs' device: (B, H, W, 3) uint8 images and
    (B, H, W, 3) targets -> {"image": normalised float32 at `size`,
    "target": float32 at `size`}. With `augment`, fast_seq parameters are
    drawn from `generator` and applied before the resize; with `shard`
    the batch is a rank's slice and the draws are the global batch's."""
    img = image_u8.to(torch.float32) / 255.0
    target = target.to(torch.float32)
    if augment:
        img, target = apply_fast_augment(img, target, _global_draws(
            lambda n: sample_fast_augment(n, generator), img.shape[0],
            shard))
    img = resize_bilinear(img, size)
    return {"image": normalize_image(img),
            "target": _resize_target(target, size)}


def train_batch_crop(generator: Optional[torch.Generator], image_u8, target,
                     size: Tuple[int, int], augment: bool = True,
                     shard=None):
    """A training batch of the `crop_and_pad` mode: with `augment`,
    fast_seq then a random crop to `size` (both drawn from `generator`,
    for the global batch with `shard`); without, the centred crop."""
    img = image_u8.to(torch.float32) / 255.0
    target = target.to(torch.float32)
    if augment:
        b = img.shape[0]
        img, target = apply_fast_augment(img, target, _global_draws(
            lambda n: sample_fast_augment(n, generator), b, shard))
        img, target = random_crop(img, target, *_global_draws(
            lambda n: sample_random_crop(n, img.shape[1:3], size, generator),
            b, shard), size)
    else:
        img, target = center_crop(img, size), center_crop(target, size)
    return {"image": normalize_image(img), "target": target}


def eval_batch_resize(image_u8, target, size: Tuple[int, int]):
    """A validation batch: no augmentation; `target` may be None."""
    out = {"image": infer_batch_resize(image_u8, size)}
    if target is not None:
        out["target"] = _resize_target(target.to(torch.float32), size)
    return out


class _TrainFlow:
    """One pass per iteration over host arrays, in a new order each time."""

    def __init__(self, images, targets, batch_size, size, generator, device,
                 augment, shard=None):
        self.images, self.targets = images, targets
        self.batch_size, self.size = batch_size, tuple(size)
        self.generator, self.device = generator, torch.device(device)
        self.augment = augment
        self.shard = shard
        self.steps = -(-len(images) // batch_size)
        _check_divides(len(images), batch_size, shard)

    def __iter__(self):
        if self.images is None:
            raise RuntimeError("the flow is closed")
        order = torch.randperm(len(self.images),
                               generator=self.generator).numpy()
        for i in range(self.steps):
            idx = rank_rows(order[i * self.batch_size:
                                  (i + 1) * self.batch_size], self.shard)
            image_b = torch.from_numpy(self.images[idx]).to(self.device)
            target_b = torch.from_numpy(self.targets[idx]).to(self.device)
            yield train_batch_resize(self.generator, image_b, target_b,
                                     self.size, self.augment, self.shard)

    def __len__(self):
        return self.steps

    def close(self):
        """Drop the references to the host arrays; the flow cannot be
        iterated again."""
        self.images = self.targets = None


def in_memory_train_flow(images_u8: np.ndarray, targets: np.ndarray,
                         batch_size: int, size: Tuple[int, int],
                         generator: torch.Generator, device="cuda",
                         augment: bool = True, shard=None):
    """(flow, steps) over (N, H, W, 3) uint8 tiles and (N, H, W, 3) targets
    (uint16 or float) held in host memory: each pass reshuffles with
    `generator`, copies each batch to `device` and preprocesses it there
    with `train_batch_resize` (augmentation parameters from the same
    generator). The last batch of a pass may be smaller. With `shard` =
    (rank, world) each batch is the rank's slice of the global one."""
    flow = _TrainFlow(images_u8, targets, batch_size, size, generator, device,
                      augment, shard)
    return flow, flow.steps


class _Prefetcher:
    """Makes the host batches on a worker thread, `depth` ahead of the
    consumer; an exception in the worker is raised to the consumer."""

    def __init__(self, make_batch, n_batches, depth=2):
        self.q = queue.Queue(maxsize=depth)
        self.n = n_batches
        self._cancelled = False

        def run():
            try:
                for i in range(n_batches):
                    if self._cancelled:
                        return
                    self.q.put(("ok", make_batch(i)))
            except Exception as e:  # surfaced to the consumer in __iter__
                self.q.put(("err", e))

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def __iter__(self):
        for _ in range(self.n):
            kind, item = self.q.get()
            if kind == "err":
                raise item
            yield item

    def cancel(self):
        """Retire the worker and drop the batches it made."""
        self._cancelled = True
        while self.thread.is_alive():
            try:
                self.q.get_nowait()
            except queue.Empty:
                self.thread.join(timeout=0.05)


class _EvalFlow:
    """One pass over the batches of `make_batch`, (images, targets or
    None, ready event or None), each preprocessed on the loader's
    device."""

    def __init__(self, loader, make_batch, steps, n_images):
        self.loader, self.make_batch = loader, make_batch
        self.steps, self.n_images = steps, n_images

    def __iter__(self):
        prefetcher = _Prefetcher(self.make_batch, self.steps)
        try:
            for image_b, target_b, ready in prefetcher:
                yield self.loader.eval_preprocess(
                    native_decode.take(image_b, ready), target_b)
        finally:
            prefetcher.cancel()

    def __len__(self):
        return self.steps


class _FileTrainFlow:
    """Training batches of image and mask files, one pass per iteration in
    a new order; the next pass's decode starts when the last batch of one
    is handed out."""

    def __init__(self, loader, X, y):
        self.loader, self.X, self.y = loader, list(X), list(y)
        self.steps = -(-len(self.X) // loader.batch_size_train)
        self._next = None
        _check_divides(len(self.X), loader.batch_size_train, loader.shard)

    def _start(self):
        bs, shard = self.loader.batch_size_train, self.loader.shard
        order = self.loader._np_rng.permutation(len(self.X))
        return _Prefetcher(lambda i: self.loader._assemble(
            self.X, self.y, rank_rows(order[i * bs:(i + 1) * bs], shard)),
            self.steps)

    def __iter__(self):
        prefetcher, self._next = self._next or self._start(), None
        for batch_id, (image_b, target_b, ready) in enumerate(prefetcher):
            if batch_id + 1 == self.steps:
                self._next = self._start()
            yield self.loader.train_preprocess(
                native_decode.take(image_b, ready), target_b)

    def __len__(self):
        return self.steps

    def close(self):
        """Retire the next pass's prefetch (the trainer calls this when the
        schedule ends)."""
        if self._next is not None:
            self._next.cancel()
            self._next = None


class SegmentationLoader:
    """Batches of image files (with their mask files for training and
    validation) or host arrays, preprocessed on `device` by the loader
    mode: `resize` to `size`, or `crop_and_pad`, which trains on random
    crops of `size` and pads each side of inference images by `pad` with
    `pad_method` (replicate or reflect). `decode_seconds` adds up the host
    time spent decoding and stacking, on the worker threads. `shard` =
    (rank, world) makes the training flow a rank's (module docstring)."""

    def __init__(self, mode: str = "resize",
                 size: Tuple[int, int] = (256, 256),
                 pad: Tuple[int, int] = (10, 10),
                 pad_method: str = "replicate",
                 batch_size_train: int = 20,
                 batch_size_inference: int = 20,
                 seed: int = 1234,
                 augment: bool = True,
                 load_in_memory: bool = False,
                 device="cuda", shard=None):
        if mode not in ("resize", "crop_and_pad"):
            raise ValueError(f"unknown loader mode {mode!r}")
        if pad_method not in PAD_FUNCTION:
            raise ValueError(f"unknown pad_method {pad_method!r}; expected "
                             f"one of {sorted(PAD_FUNCTION)}")
        self.mode = mode
        self.size = tuple(size)
        self.pad = tuple(pad)
        self.pad_method = pad_method
        self.batch_size_train = batch_size_train
        self.batch_size_inference = batch_size_inference
        self.augment = augment
        self.device = torch.device(device)
        self.shard = shard
        self._cache = {} if load_in_memory else None
        self._lock = threading.Lock()
        self._np_rng = np.random.RandomState(seed)
        self._generator = torch.Generator().manual_seed(seed)
        self._decoder = native_decode.DeviceDecoder(self.device)
        self.decode_seconds = 0.0

    def _cached(self, load, path):
        if self._cache is None:
            return load(path)
        hit = self._cache.get(path)
        if hit is None:
            hit = self._cache[path] = load(path)
        return hit

    def _decode_many(self, load, paths, threaded):
        """Decode files on up to 8 threads when `threaded` (the decoder
        releases the GIL: a JPEG's Huffman decode, libpng). The stdlib PNG
        reader holds the GIL between its numpy calls, and threads
        contending for it decode slower than one thread, so its files are
        decoded in turn."""
        paths = list(paths)
        workers = min(8, os.cpu_count() or 1)
        if len(paths) <= 1 or workers <= 1 or not threaded:
            return [self._cached(load, p) for p in paths]
        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(lambda p: self._cached(load, p), paths))

    def _assemble(self, image_paths, target_paths, idxs):
        """(images (B, H, W, 3) uint8 on the loader's device, targets
        (B, H, W, 3) on the host or None, ready: the event of
        `native_decode.DeviceDecoder`) of the files at `idxs`: the files'
        host decode on the threads, then one pixel-stage call per JPEG
        geometry onto the device, on the loader's own stream on a card
        (so `decode_seconds` runs to the kernels' end). Targets
        are uint16, or float32 for a batch of mixed sizes, which is
        resized to `size` on the host (the images too, there). The
        `load_in_memory` cache holds the host halves, not device tiles."""
        start = time.perf_counter()
        paths = np.asarray(image_paths)[idxs]
        items = self._decode_many(
            native_decode.read_image, paths,
            all(native_decode.releases_gil(p) for p in paths))
        mixed = len({native_decode.image_size(it) for it in items}) > 1
        targets = None
        if target_paths is not None:
            targets = self._decode_many(load_target,
                                        np.asarray(target_paths)[idxs],
                                        native_decode.available())
            if mixed:
                targets = [resize_target_f32(t, self.size) for t in targets]
            targets = np.stack(targets)
        images, ready = self._decoder(items, self.size if mixed else None)
        with self._lock:
            self.decode_seconds += time.perf_counter() - start
        return images, targets, ready

    def infer_preprocess(self, image_u8_batch):
        """(B, H, W, 3) uint8 (numpy or tensor) -> normalised float32
        images on the loader's device, by the loader mode."""
        return self.device_preprocess(
            torch.as_tensor(image_u8_batch).to(self.device))

    def device_preprocess(self, image_u8):
        """The same on a uint8 tensor, on its own device (the preprocess
        of an exported serve program, infer/serving.ServeProgram)."""
        if self.mode == "resize":
            return infer_batch_resize(image_u8, self.size)
        return infer_batch_pad(image_u8, self.pad, self.pad_method)

    def eval_preprocess(self, image_u8_batch, target_batch=None):
        """{"image": ..., "target": ...} of a validation batch on the
        loader's device (no "target" without targets): resized to `size`,
        or padded as inference pads, the targets with the images' pad
        method."""
        out = {"image": self.infer_preprocess(image_u8_batch)}
        if target_batch is not None:
            target = torch.as_tensor(target_batch).to(self.device).to(
                torch.float32)
            out["target"] = (_resize_target(target, self.size)
                             if self.mode == "resize" else
                             pad_fixed(target, self.pad, self.pad_method))
        return out

    def train_preprocess(self, image_u8_batch, target_batch):
        """A training batch on the loader's device by the loader mode,
        augmented when `augment` is set."""
        make = (train_batch_resize if self.mode == "resize"
                else train_batch_crop)
        return make(self._generator,
                    torch.as_tensor(image_u8_batch).to(self.device),
                    torch.as_tensor(target_batch).to(self.device),
                    self.size, self.augment, self.shard)

    def _eval_gen(self, n, host_batch, with_targets):
        """(flow, steps): batches of `batch_size_inference` from
        host_batch(indices). Without targets the ragged tail is padded with
        duplicates of the last image, so every batch has one shape;
        validation batches stay ragged (padding would bias the mean loss).
        `flow.n_images` is the real count."""
        bs = self.batch_size_inference
        steps = -(-n // bs)

        def make_batch(i):
            idxs = np.arange(i * bs, min((i + 1) * bs, n))
            if not with_targets and len(idxs) < bs:
                idxs = np.concatenate([idxs, np.full(bs - len(idxs),
                                                     idxs[-1])])
            return host_batch(idxs)

        return _EvalFlow(self, make_batch, steps, n), steps

    def array_flow(self, images_u8):
        """(flow, steps) over (N, H, W, 3) uint8 tiles in host memory."""
        images_u8 = np.asarray(images_u8)
        return self._eval_gen(len(images_u8),
                              lambda idxs: (images_u8[idxs], None, None),
                              False)

    def _file_flow(self, X, y):
        X = list(X)
        y = None if y is None else list(y)
        return self._eval_gen(len(X), lambda idxs: self._assemble(X, y, idxs),
                              y is not None)

    def transform(self, X, y=None, X_valid=None, y_valid=None,
                  train_mode=True, **kwargs):
        """{"datagen": (flow, steps), "validation_datagen": (flow, steps) or
        (None, None)} for the image paths X and mask paths y: a training
        flow with `train_mode` and targets, else a validation flow (with
        targets) or an inference flow (train_mode False ignores y); the
        validation flow of X_valid, y_valid where both are given."""
        if train_mode and y is not None:
            flow = _FileTrainFlow(self, X, y)
            steps = flow.steps
        else:
            flow, steps = self._file_flow(X, None if train_mode else y)
        valid = (self._file_flow(X_valid, y_valid)
                 if X_valid is not None and y_valid is not None
                 else (None, None))
        return {"datagen": (flow, steps), "validation_datagen": valid}
