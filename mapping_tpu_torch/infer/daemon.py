"""Online serving daemon: microbatched, double-buffered serving over HTTP.

Counterpart of mapping_tpu/infer/daemon.py. The daemon is the online face
of the same serve program the pipelines run (infer/serving.py FusedServe,
or an exported artifact, infer/artifact.py):

 - requests POST one image each (JPEG/PNG bytes or a .npy array); HTTP
   handler threads decode them (utils/native_decode: a JPEG through the
   port's decoder, its Huffman decode on the host and its pixel stage on
   the serving device, where a tile of the daemon's size stays for the
   batcher; a PNG through libpng or the standard-library reader; a body
   either refuses is a 400) and resize them on the host to the tile size
   when they differ (utils/resize, Pillow's bilinear resample);
 - a microbatcher coalesces requests up to the pipeline's
   `batch_size_inference` (waiting at most `max_wait_ms` after the first
   request of a batch) and pads the ragged tail by repeating rows up to the
   smallest batch-shape bucket that fits (`serve_batch_buckets`);
 - batches are double-buffered through dispatch()/collect(): batch k+1 is
   enqueued on the device before batch k's outputs are copied back;
 - responses carry COCO result annotations (RLE counts, bbox, score) via
   infer.annotations.labeled_to_annotations, the same dicts evaluate
   writes to prediction.json.

Endpoints:
    POST /v1/predict       image bytes -> {"annotations": [...], ...}
    GET  /v1/health        {"status": "ok", "batch_size": B, ...}
    GET  /v1/stats         request/batch counters, mean batch occupancy,
                           latency quantiles

Transport is the standard library's ThreadingHTTPServer; a handler thread
does one queue put and one event wait and never touches the device. Start
it with `python3 -m mapping_tpu_torch.main serve -p unet`. With
`quantized_serving: 1` a weight change rebuilds the int8 tables in the
background while the previous snapshot serves; `param_source_stats`
(in /v1/stats) counts those rebuilds. With `data_parallel: 1` over more
than one card the pipeline serves a replica per card, and the bucket
sizes that do not divide over them are dropped with a warning, as in the
JAX daemon (`mesh_buckets`; the full batch is kept). With
`spatial_serving: 1` each image's rows split over the devices instead,
so every bucket is kept, as in the JAX daemon.
"""

import io
import json
import logging
import os
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from mapping_tpu_torch.infer.annotations import labeled_to_annotations

logger = logging.getLogger(__name__)


class _Pending:
    """One in-flight request: decoded image in, annotations (or error) out."""

    __slots__ = ("image", "image_id", "done", "annotations", "error")

    def __init__(self, image, image_id=0):
        self.image = image
        self.image_id = image_id
        self.done = threading.Event()
        self.annotations = None
        self.error = None


class Microbatcher:
    """Coalesce single-image requests into fixed-shape device batches.

    serve: dispatch/collect (FusedServe, or ArtifactServe). preprocess:
    maps a stacked uint8 (B, H, W, 3) tensor (on the serving device where
    a request's tile was decoded there, else on the host) to the serve
    program's input (the loader's `infer_preprocess`; the identity for an
    artifact). Two worker threads connect through a depth-1 handle queue:
    the batcher dispatches, the collector copies back, one batch always in
    flight.
    """

    def __init__(self, serve, preprocess, batch_size: int,
                 category_ids: Sequence[Optional[int]],
                 category_layers: Sequence[int],
                 max_wait_ms: float = 5.0,
                 request_timeout: float = 300.0,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 convert=None,
                 max_pending: Optional[int] = None):
        self._serve = serve
        self._preprocess = preprocess
        self._batch = int(batch_size)
        # convert(image_id, outs, i) -> annotations for image i of a
        # collected batch; None = the plain labels/scores conversion (a
        # scoring daemon rescores and suppresses per image here)
        self._convert = convert or self._convert_plain
        # a batch pads up to the SMALLEST bucket that fits, so a lone
        # request pays a batch-1 program, not the full batch; always
        # includes batch_size
        buckets = sorted(set(int(b) for b in (bucket_sizes or []))
                         | {self._batch})
        if buckets[0] < 1 or buckets[-1] > self._batch:
            raise ValueError(f"bucket sizes must be in [1, {self._batch}], "
                             f"got {buckets}")
        self._buckets = buckets
        self._cat_ids = list(category_ids)
        self._cat_layers = list(category_layers)
        self._max_wait = float(max_wait_ms) / 1000.0
        self._request_timeout = float(request_timeout)
        # backpressure: past max_pending queued requests submit() raises
        # OverloadedError (HTTP 429); a BOUNDED queue makes the cap atomic
        # where a qsize() check-then-put would overshoot under a flood
        self._max_pending = int(max_pending if max_pending is not None
                                else 8 * self._batch)
        if self._max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1, got {self._max_pending}")
        self._requests = queue.Queue(maxsize=self._max_pending)
        self._inflight = queue.Queue(maxsize=1)  # depth-1 = double buffer
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()  # handler threads bump counters
        self.stats = {"requests": 0, "batches": 0, "images_padded": 0,
                      "rejected_overload": 0, "timeouts": 0, "errors": 0,
                      "bucket_batches": {str(b): 0 for b in buckets}}
        # per-request wall time (submit -> done), bounded window
        self._latencies = deque(maxlen=4096)
        self._threads = [
            threading.Thread(target=self._batch_loop, daemon=True,
                             name="serve-batcher"),
            threading.Thread(target=self._collect_loop, daemon=True,
                             name="serve-collector"),
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------- client
    def submit(self, image: np.ndarray, timeout: Optional[float] = None,
               image_id: int = 0):
        """Blocking: enqueue one (H, W, 3) uint8 image, wait for its
        annotations. Raises TimeoutError after `timeout` (default: the
        batcher's request_timeout, never unbounded), OverloadedError when
        the queue is full, or RuntimeError on a worker-side failure."""
        if self._stop.is_set():
            raise RuntimeError("daemon is shut down")
        pending = _Pending(image, image_id)
        t0 = time.monotonic()
        try:
            self._requests.put_nowait(pending)
        except queue.Full:
            with self._stats_lock:
                self.stats["rejected_overload"] += 1
            raise OverloadedError(
                f"{self._max_pending} requests already queued; "
                "retry later") from None
        if self._stop.is_set() and not pending.done.is_set():
            # close() may already have drained the queue: fail fast
            pending.error = (pending.error
                             or "daemon shut down before serving the request")
            pending.done.set()
        if not pending.done.wait(timeout if timeout is not None
                                 else self._request_timeout):
            self._record_failure(t0, "timeouts")
            raise TimeoutError("prediction timed out")
        if pending.error is not None:
            self._record_failure(t0, "errors")
            raise RuntimeError(pending.error)
        self._latencies.append(time.monotonic() - t0)
        return pending.annotations

    def _record_failure(self, t0, counter):
        """A failed request enters the same latency window the quantiles
        read (a timeout with its whole duration), so p95/p99 show a sick
        daemon instead of only the survivors."""
        self._latencies.append(time.monotonic() - t0)
        with self._stats_lock:
            self.stats[counter] += 1

    def param_source_stats(self):
        """Recalibration counters of an int8 serve program
        (FusedServe.recalibration_stats); {} for a float or an artifact
        serve."""
        fn = getattr(self._serve, "recalibration_stats", None)
        return fn() if fn is not None else {}

    def latency_quantiles(self):
        """{p50, p95, p99} in ms over the recent served-request window."""
        window = list(self._latencies)
        if not window:
            return {}
        qs = np.quantile(np.asarray(window), [0.5, 0.95, 0.99])
        return {f"latency_ms_p{p}": round(float(v) * 1e3, 1)
                for p, v in zip((50, 95, 99), qs)}

    def close(self):
        self._stop.set()
        # unblock the batcher's get (a full queue does not need it)
        try:
            self._requests.put_nowait(None)
        except queue.Full:
            pass
        for t in self._threads:
            t.join(timeout=5)
        # fail anything still queued so no submit() waits forever
        while True:
            try:
                pending = self._requests.get_nowait()
            except queue.Empty:
                break
            if pending is not None:
                pending.error = "daemon shut down before serving the request"
                pending.done.set()

    # ------------------------------------------------------------ workers
    def _take_batch(self):
        """Up to batch_size requests; after the first arrives, wait at most
        max_wait for stragglers."""
        # stop-aware first get: close()'s sentinel is dropped when the
        # bounded queue is full, so poll rather than block for good
        while True:
            try:
                first = self._requests.get(timeout=0.25)
                break
            except queue.Empty:
                if self._stop.is_set():
                    return None
        if first is None:
            return None
        if self._stop.is_set():
            first.error = "daemon shut down before serving the request"
            first.done.set()
            return None
        batch = [first]
        deadline = time.monotonic() + self._max_wait
        while len(batch) < self._batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._requests.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _batch_loop(self):
        while not self._stop.is_set():
            batch = self._take_batch()
            if not batch:
                continue
            try:
                bucket = next(b for b in self._buckets if b >= len(batch))
                pad = bucket - len(batch)
                images = _stack([p.image for p in batch], pad)
                self.stats["images_padded"] += pad
                self.stats["bucket_batches"][str(bucket)] += 1
                handle = self._serve.dispatch(self._preprocess(images))
                self._inflight.put((handle, batch))
            except Exception as exc:  # noqa: BLE001 - report to callers
                logger.exception("serve batcher failed")
                for p in batch:
                    p.error = repr(exc)
                    p.done.set()
        self._inflight.put(None)

    def _collect_loop(self):
        while True:
            item = self._inflight.get()
            if item is None:
                return
            handle, batch = item
            try:
                outs = self._serve.collect(handle)
            except Exception as exc:  # noqa: BLE001 - report to callers
                logger.exception("serve collector failed")
                for p in batch:
                    p.error = repr(exc)
                    p.done.set()
                continue
            # a conversion failure (the scoring rescore / NMS) fails ONLY
            # its own request, not the whole batch
            for i, p in enumerate(batch):
                try:
                    p.annotations = self._convert(p.image_id, outs, i)
                except Exception as exc:  # noqa: BLE001
                    logger.exception("annotation conversion failed for "
                                     "image %s", p.image_id)
                    p.error = repr(exc)
                p.done.set()
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1

    def _convert_plain(self, image_id, outs, i):
        return labeled_to_annotations(
            image_id, np.asarray(outs[0][i]), np.asarray(outs[1][i]),
            self._cat_ids, self._cat_layers)


def _stack(images, pad):
    """(len(images) + pad, H, W, 3) uint8 tensor of the requests' tiles,
    the last repeated `pad` times: on the device of the tiles the decoder
    left on a card, else on the host. A card's tile is made safe for the
    current stream (`native_decode.take`)."""
    from mapping_tpu_torch.utils import native_decode

    tiles = [native_decode.take(torch.as_tensor(im)) for im in images]
    device = next((t.device for t in tiles if t.is_cuda),
                  torch.device("cpu"))
    tiles = [t.to(device) for t in tiles]
    return torch.stack(tiles + tiles[-1:] * pad)


class RequestError(ValueError):
    """Client-side problem with a request body (HTTP 400)."""


class OverloadedError(RuntimeError):
    """Request queue at capacity: shed load (HTTP 429)."""


def _max_pending_from(params):
    """`serve_max_pending` -> Microbatcher max_pending (None = the 8x-batch
    default). 0 means the default; a negative value is a config error."""
    value = int(params.get("serve_max_pending", 0))
    if value < 0:
        raise ValueError(
            f"serve_max_pending must be >= 0 (0 = default), got {value}")
    return value or None


def mesh_buckets(buckets, mesh, batch):
    """The bucket sizes a serving mesh can cut into equal shards: those
    that do not divide over its data axis are dropped with a warning (the
    full batch stays, as in the JAX daemon)."""
    if mesh is None:
        return buckets
    n = len(mesh)
    bad = [b for b in buckets if b % n and b != batch]
    if bad:
        logger.warning("serve_batch_buckets %s dropped: not divisible by "
                       "the %d-device data mesh", bad, n)
    return [b for b in buckets if b % n == 0 or b == batch]


def parse_serve_buckets(params):
    """`serve_batch_buckets` -> sorted bucket list INCLUDING the full
    `batch_size_inference` shape; one parser for the daemon and the
    artifact exporter. Out-of-range entries are dropped with a warning."""
    batch = int(params.batch_size_inference)
    buckets = {batch}
    dropped = []
    spec = str(params.get("serve_batch_buckets", "")).strip()
    if spec:
        for tok in spec.split(","):
            if tok.strip():
                b = int(tok)
                if 1 <= b <= batch:
                    buckets.add(b)
                else:
                    dropped.append(b)
    if dropped:
        logger.warning("serve_batch_buckets %s dropped: outside "
                       "[1, batch_size_inference=%d]", dropped, batch)
    return sorted(buckets)


def decode_request_image(body: bytes, content_type: str,
                         target_hw, decoder=None):
    """Request bytes -> (H, W, 3) uint8 at the daemon's tile shape: a
    host array, or a tensor on the serving device.

    .npy arrays pass through (uint8, floats in [0, 1] scaled to 255, or
    integers in [0, 255]; anything else is a RequestError rather than a
    silent truncation); image bytes decode through utils/native_decode.
    A JPEG, or a JPEG-compressed TIFF, has its pixel stage run by
    `decoder` (the daemon's `native_decode.DeviceDecoder`: `jpeg_pixels`
    on a stream of its own on a card, finished when this returns), and a
    tile of the daemon's size stays on that device for the batcher; None
    decodes it on the host. A
    tile of another size is resized on the host (utils/resize, Pillow's
    bilinear)."""
    from mapping_tpu_torch.utils import native_decode
    from mapping_tpu_torch.utils.resize import resize_bilinear_u8

    h, w = target_hw
    if "npy" in content_type or body[:6] == b"\x93NUMPY":
        try:
            arr = np.load(io.BytesIO(body), allow_pickle=False)
        except Exception as exc:
            raise RequestError(f"invalid .npy body: {exc!r}") from exc
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise RequestError(f"expected (H, W, 3) array, got {arr.shape}")
        if arr.dtype == np.uint8:
            pass
        elif np.issubdtype(arr.dtype, np.floating):
            if not np.isfinite(arr).all() or arr.min() < 0 or \
                    arr.max() > 1.001:
                raise RequestError(
                    "float image must be in [0, 1] (got range "
                    f"[{arr.min():.3g}, {arr.max():.3g}])")
            arr = np.round(arr * 255.0).astype(np.uint8)
        elif np.issubdtype(arr.dtype, np.integer):
            if arr.min() < 0 or arr.max() > 255:
                raise RequestError(
                    "integer image must be in [0, 255] (got range "
                    f"[{arr.min()}, {arr.max()}])")
            arr = arr.astype(np.uint8)
        else:
            raise RequestError(f"unsupported array dtype {arr.dtype}")
    else:
        try:
            item = native_decode.read_bytes(body)
        except Exception as exc:
            raise RequestError(
                f"undecodable image bytes: {exc!r}") from exc
        if decoder is None or isinstance(item, np.ndarray):
            arr = native_decode.to_rgb(item)
        else:
            tile = decoder([item])[0][0]
            if tuple(tile.shape[:2]) == (h, w):
                return tile
            arr = tile.cpu().numpy()
    if arr.shape[:2] != (h, w):
        arr = resize_bilinear_u8(arr, (h, w))
    return arr


def _make_handler(batcher: Microbatcher, target_hw, info: dict, decoder):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, payload):
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/health":
                self._reply(200, {"status": "ok", **info})
            elif self.path == "/v1/stats":
                stats = dict(batcher.stats)
                if stats["batches"]:
                    stats["mean_batch_occupancy"] = round(
                        stats["requests"] / stats["batches"], 2)
                stats.update(batcher.latency_quantiles())
                stats.update(batcher.param_source_stats())
                self._reply(200, stats)
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/v1/predict":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                image = decode_request_image(
                    body, self.headers.get("Content-Type", ""), target_hw,
                    decoder)
                image_id = int(self.headers.get("X-Image-Id", 0))
                t0 = time.perf_counter()
                annotations = batcher.submit(image, image_id=image_id)
                self._reply(200, {
                    "annotations": annotations,
                    "latency_ms": round(
                        (time.perf_counter() - t0) * 1000, 2),
                })
            except (RequestError, ValueError) as exc:  # malformed request
                self._reply(400, {"error": repr(exc)})
            except OverloadedError as exc:  # queue full: shed load
                self._reply(429, {"error": repr(exc)})
            except TimeoutError as exc:  # overloaded / wedged device
                self._reply(503, {"error": repr(exc)})
            except Exception as exc:  # noqa: BLE001 - server-side failure
                logger.exception("predict handler failed")
                self._reply(500, {"error": repr(exc)})

        def log_message(self, fmt, *args):  # route through our logger
            logger.debug("http: " + fmt, *args)

    return Handler


class ServingDaemon:
    """HTTP server around a Microbatcher; see module docstring."""

    def __init__(self, batcher: Microbatcher, target_hw, info: dict, *,
                 device, host: str = "127.0.0.1", port: int = 8000):
        """`device`: the serving device, where a JPEG body's pixel stage
        runs (the serve program's)."""
        from mapping_tpu_torch.utils.native_decode import DeviceDecoder

        self.batcher = batcher
        handler = _make_handler(batcher, target_hw, info,
                                DeviceDecoder(device))
        self.server = ThreadingHTTPServer((host, port), handler)
        self.port = self.server.server_address[1]

    def serve_forever(self):
        logger.info("serving on http://%s:%d (POST /v1/predict)",
                    self.server.server_address[0], self.port)
        try:
            self.server.serve_forever()
        finally:
            self.batcher.close()

    def start_background(self):
        t = threading.Thread(target=self.server.serve_forever, daemon=True,
                             name="serve-http")
        t.start()
        return t

    def shutdown(self):
        self.server.shutdown()
        self.server.server_close()
        self.batcher.close()


def scoring_convert_fn(model, category_layers, iou_threshold,
                       emit_suppressed=True):
    """Per-image annotation converter of a scoring-model serve (the
    Microbatcher `convert` protocol): the serve program's 4th output is
    the per-instance feature tensor; each image gets the GBM's IoU
    rescoring and the cross-layer NMS on the host before the COCO
    conversion. Shared by the live daemon and artifact replay."""
    from mapping_tpu_torch.constants import CATEGORY_IDS
    from mapping_tpu_torch.scoring import (features_from_tensor,
                                           remove_overlapping_masks)

    category_layers = list(category_layers)
    iou_threshold = float(iou_threshold)

    def convert(image_id, outs, i):
        labels = np.asarray(outs[0][i])
        frames = features_from_tensor(
            np.asarray(outs[3][i]), labels,
            category_layers=category_layers)
        scores = model.transform([frames])["scores"][0]
        labels, scores = remove_overlapping_masks(
            labels, scores, iou_threshold)
        return labeled_to_annotations(image_id, labels, scores,
                                      CATEGORY_IDS, category_layers,
                                      emit_suppressed=emit_suppressed)

    return convert


def unwrap_scoring_pipeline(pipeline, entry="serve"):
    """(scoring_or_None, base_pipeline) for an inference pipeline that may
    be a ScoringInferencePipeline: the guards of the offline entry points,
    and the trained scoring model loaded. Raises on train-only
    pipelines."""
    if hasattr(pipeline, "trainer"):
        return None, pipeline
    if not (hasattr(pipeline, "nms") and hasattr(
            getattr(pipeline, "base", None), "trainer")):
        raise ValueError(
            f"{entry} supports the segmentation pipelines (unet*) and "
            f"their *_scoring_model variants; {type(pipeline).__name__} "
            "is train-only")
    cl = list(pipeline.category_layers)
    if len(cl) < 2 or cl[1] <= 1:
        # a GBM trained on 19 threshold layers scoring a [1, 1] program's
        # features would serve meaningless IoUs
        raise ValueError(
            f"{entry} with a scoring-model pipeline requires multiple "
            "thresholds: set category_layers to [1, 19]")
    pipeline._load_model()
    return pipeline, pipeline.base


def daemon_from_pipeline(pipeline, config, host="127.0.0.1", port=8000,
                         max_wait_ms=5.0, max_pending=None):
    """The daemon over a trained inference pipeline: its weights (the
    port's unet.pt or a JAX unet.msgpack), the SAME FusedServe `evaluate`
    runs, and the loader's device preprocess, so a served request sees the
    offline input transform. Every bucket is run once before the server
    starts."""
    from mapping_tpu_torch.constants import CATEGORY_IDS

    scoring, pipeline = unwrap_scoring_pipeline(pipeline, entry="serve")
    pipeline._ensure_weights()
    serve = pipeline.serve_program(return_features=scoring is not None)
    if serve.enable_async_recalibration():
        logger.info("quantized serving: weight-change recalibration runs in "
                    "the background (the previous snapshot serves until the "
                    "swap)")
    convert = None
    if scoring is not None:
        convert = scoring_convert_fn(
            scoring.model, scoring.category_layers,
            scoring.nms.iou_threshold,
            emit_suppressed=bool(config.params.get("emit_suppressed", 0)))

    params = config.params
    # requests come in at the dataset tile size; the loader then resizes
    # or pads them on the device, per mode
    tile = (int(params.crop_image_h), int(params.crop_image_w))
    batch = int(params.batch_size_inference)
    preprocess = pipeline.loader.infer_preprocess
    batcher = Microbatcher(
        serve, preprocess, batch,
        category_ids=CATEGORY_IDS,
        category_layers=pipeline.category_layers,
        max_wait_ms=max_wait_ms,
        bucket_sizes=mesh_buckets(
            parse_serve_buckets(params),
            None if getattr(serve, "spatial", None)
            else getattr(serve, "mesh", None), batch),
        convert=convert,
        max_pending=(max_pending if max_pending is not None
                     else _max_pending_from(params)))
    for b in batcher._buckets:
        warm = np.zeros((b, tile[0], tile[1], 3), np.uint8)
        serve.collect(serve.dispatch(preprocess(warm)))
    info = {"batch_size": batch, "batch_buckets": batcher._buckets,
            "image_hw": list(tile),
            "loader_mode": pipeline.loader.mode,
            "platform": pipeline.loader.device.type,
            "scoring_model": scoring is not None,
            "pipeline": (type(scoring).__name__ if scoring is not None
                         else type(pipeline).__name__)}
    return ServingDaemon(batcher, tile, info, host=host, port=port,
                         device=pipeline.loader.device)


def daemon_from_artifact(directory, host="127.0.0.1", port=8000,
                         max_wait_ms=5.0, max_pending=None, device=None):
    """The daemon over an exported artifact (`serve --artifact DIR`): no
    model code, pipeline or checkpoint; the programs hold the device
    preprocess, so the batcher's preprocess is the identity and the
    buckets are the artifact's exported shapes. `device` as in
    `load_artifact`."""
    from mapping_tpu_torch.constants import CATEGORY_IDS
    from mapping_tpu_torch.infer.artifact import load_artifact

    art = load_artifact(directory, device=device)
    manifest = art.manifest
    tile = art.image_hw
    buckets = list(manifest["batch_buckets"])
    batcher = Microbatcher(
        art, lambda images: images, max(buckets),
        category_ids=CATEGORY_IDS,
        category_layers=manifest["category_layers"],
        max_wait_ms=max_wait_ms,
        bucket_sizes=buckets,
        convert=art.converter(),  # GBM rescore + NMS for scoring artifacts
        max_pending=max_pending)
    for b in buckets:  # the first replay of each program
        art.collect(art.dispatch(np.zeros((b,) + tile + (3,), np.uint8)))
    info = {"batch_size": max(buckets), "batch_buckets": buckets,
            "image_hw": list(tile),
            "loader_mode": manifest["loader_mode"],
            "platform": art.device.type,
            "scoring_model": bool(manifest.get("scoring_model")),
            "pipeline": manifest["pipeline"],
            "artifact": os.fspath(directory),
            "artifact_device": manifest["exported_on_device"]}
    return ServingDaemon(batcher, tile, info, host=host, port=port,
                         device=art.device)
