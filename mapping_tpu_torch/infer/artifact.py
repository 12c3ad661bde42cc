"""Serving artifacts: the serve program, exported with torch.export.

Counterpart of mapping_tpu/infer/artifact.py. `export_serving_artifact`
exports the whole serving program of a pipeline (infer/serving.
ServeProgram: uint8 tiles -> the loader mode's device preprocess ->
forward (+TTA, +centre crop) -> softmax -> fused postprocess -> int16
labels, scores, areas [, features]) once per batch bucket. A deployment
loads it with `load_artifact()` and serves without the model code, the
pipeline or a checkpoint.

Artifact directory layout (the port's own; a JAX artifact is refused):

    manifest.json       the JAX manifest's geometry, buckets, outputs and
                        pipeline fields, with `torch_version` and
                        `exported_on_device` in place of `jax_version` and
                        `platforms`; `quantized` says whether the
                        program holds the int8 forward (its qtable
                        snapshot at export)
    serve_b{B}.pt2      torch.export.save of one bucket's program; each
                        holds its own copy of the weights (torch.export
                        lifts them into the program's state dict), so an
                        artifact of k buckets holds k copies
    scoring_model.pkl   (scoring exports only) the GBM regressor, in the
                        port's pickle; `converter()` rebuilds the host
                        rescore + NMS from it and the features output

The CCL labelling inside a program is the registered op
`mapping_tpu_torch::ccl_label` (ops/ccl.py), so a program exported on the
card replays the CUDA kernels; loading imports ops/ccl first. A program is
bound to the device class it was exported on: constants made inside it
(the thresholds and index tensors of the postprocess) carry the exporting
device. `load_artifact(..., device=...)` on another class raises instead
of moving it. `replicate()` copies the programs to the other cards of the
same class (torch.export's move_to_device_pass) and replays chunks round
robin over them.

A program is a single-device computation, as in the JAX package:
`spatial_serving: 1` and `data_parallel: 1` shape the live pipelines'
serving only, so an export with either writes the same single-device
programs; `replicate()` is the artifact's way over several cards.

Numerics: a program replays the same ATen ops as the live FusedServe on
the same device (TF32 off, as the live float32 path), so the replay is
expected to equal it bit for bit. Overflow differs in one way, as in the
JAX package: a fixed program cannot widen its instance pad, so images
with more components than `max_instances` keep the tail-drop with a
one-time warning instead of escalating.
"""

import json
import logging
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from mapping_tpu_torch.models.quantize import QuantizedConv
from mapping_tpu_torch.train.step import _no_tf32

logger = logging.getLogger(__name__)

ARTIFACT_VERSION = 1
_MANIFEST = "manifest.json"
_SCORING_MODEL = "scoring_model.pkl"
DEVICE_CLASSES = ("cpu", "cuda")


def _program_file(batch: int) -> str:
    return f"serve_b{batch}.pt2"


def export_serving_artifact(pipeline, config, out_dir: str,
                            platforms: Optional[Sequence[str]] = None):
    """Export `pipeline`'s serve program to `out_dir`, one program per
    bucket of `parse_serve_buckets`; returns the manifest dict.

    The programs are exported on the pipeline's device (the config's
    `device`). `platforms`, where given, must name that one device class
    (cpu or cuda): a program runs only on the class it was exported on."""
    from mapping_tpu_torch.infer.daemon import (parse_serve_buckets,
                                                unwrap_scoring_pipeline)

    scoring, pipeline = unwrap_scoring_pipeline(pipeline, entry="export")
    device = pipeline.loader.device
    if platforms:
        platforms = [str(p).strip() for p in platforms]
        if len(platforms) != 1 or platforms[0] not in DEVICE_CLASSES:
            raise ValueError(
                f"export --platforms takes one device class of "
                f"{DEVICE_CLASSES}, got {platforms}: a torch.export program "
                f"runs on the class it was exported on")
        if platforms[0] != device.type:
            raise ValueError(
                f"export --platforms {platforms[0]} but the pipeline runs "
                f"on {device.type}: set `device: {platforms[0]}` in the "
                f"config to export for it")
    module = pipeline.serve_module(return_features=scoring is not None)
    module.eval()
    cfg = config.params
    tile = (int(cfg.crop_image_h), int(cfg.crop_image_w))
    buckets = parse_serve_buckets(cfg)
    os.makedirs(out_dir, exist_ok=True)
    for batch in buckets:
        example = torch.zeros((batch,) + tile + (3,), dtype=torch.uint8,
                              device=device)
        start = time.perf_counter()
        with torch.no_grad():
            program = torch.export.export(module, (example,))
        path = os.path.join(out_dir, _program_file(batch))
        torch.export.save(program, path)
        logger.info("exported %s (%s) in %.2f s, %.1f MiB", path,
                    " x ".join(str(d) for d in (batch,) + tile),
                    time.perf_counter() - start,
                    os.path.getsize(path) / 2 ** 20)

    if scoring is not None:
        scoring.model.save(os.path.join(out_dir, _SCORING_MODEL))
    out_names = ["labels_i16", "scores", "areas"]
    if module.post["compute_features"]:
        out_names.append("features")
    manifest = {
        "artifact_version": ARTIFACT_VERSION,
        "torch_version": torch.__version__,
        "exported_on_device": device.type,
        "batch_buckets": buckets,
        "image_hw": list(tile),
        "input_dtype": "uint8",
        "outputs": out_names,
        "target_size": list(module.post["target_size"]),
        "category_layers": list(module.post["category_layers"]),
        "max_instances": module.max_instances,
        "tta_variants": module.tta_variants,
        "quantized": any(isinstance(m, QuantizedConv)
                         for m in module.modules()),
        "loader_mode": pipeline.loader.mode,
        "pipeline": (type(scoring).__name__ if scoring is not None
                     else type(pipeline).__name__),
        "encoder": str(cfg.encoder),
        "scoring_model": scoring is not None,
    }
    if scoring is not None:
        manifest["nms_iou_threshold"] = float(scoring.nms.iou_threshold)
        # replay follows the exporting config's writer semantics: drop
        # NMS-suppressed (score 0) instances unless emit_suppressed: 1
        manifest["emit_suppressed"] = int(cfg.get("emit_suppressed", 0))
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _refuse_jax_artifact(directory, manifest):
    """A JAX artifact (StableHLO `serve_b{B}.bin` programs, params.npz,
    `jax_version` in its manifest) raises, naming what it holds."""
    files = sorted(f for f in os.listdir(directory)
                   if f.endswith(".bin") or f == "params.npz")
    if "jax_version" in manifest or files:
        raise ValueError(
            f"{directory} holds a JAX serving artifact (jax_version "
            f"{manifest.get('jax_version')!r}, files {files}): its "
            f"StableHLO programs do not run under PyTorch; export the "
            f"pipeline with `python3 -m mapping_tpu_torch.main export`")


def _as_tiles(images_u8) -> torch.Tensor:
    """A batch of tiles as a uint8 tensor: a host array is converted (as
    np.ascontiguousarray(..., uint8)), a tensor must be uint8 already."""
    if not isinstance(images_u8, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(images_u8,
                                                     dtype=np.uint8))
    if images_u8.dtype != torch.uint8:
        raise ValueError(f"expected uint8 tiles, got {images_u8.dtype}")
    return images_u8


class ArtifactServe:
    """A loaded artifact: callable (B, H, W, 3) uint8 -> numpy
    (labels (B, L, th, tw) int16, scores, areas [, features]).

    Pads a batch up to the smallest exported bucket and trims the outputs
    back; batches larger than the biggest bucket run in bucket-size
    chunks, one chunk in flight per replica."""

    def __init__(self, directory: str, device=None):
        # the op must be registered before a program that calls it loads
        import mapping_tpu_torch.ops.ccl  # noqa: F401

        self._dir = os.fspath(directory)
        with open(os.path.join(self._dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        _refuse_jax_artifact(self._dir, self.manifest)
        if self.manifest.get("artifact_version") != ARTIFACT_VERSION:
            raise ValueError(
                f"artifact version {self.manifest.get('artifact_version')} "
                f"!= supported {ARTIFACT_VERSION}")
        exported = self.manifest["exported_on_device"]
        self.device = torch.device(device if device is not None
                                   else exported)
        if self.device.type != exported:
            raise ValueError(
                f"the artifact at {self._dir} was exported on {exported} "
                f"and cannot run on {self.device}: a program runs on the "
                f"device class it was exported on; export it again there")
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"the artifact at {self._dir} runs on a "
                                   f"CUDA card, and there is none")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self._exported = {}
        self._programs = {}
        for batch in self.manifest["batch_buckets"]:
            program = torch.export.load(
                os.path.join(self._dir, _program_file(batch)))
            if self.device != _program_device(program, self.device):
                program = _moved(program, self.device)
            self._exported[batch] = program
            self._programs[batch] = program.module()
        self._buckets = sorted(self._programs)
        self._warned_overflow = False
        self._replicas = None  # replicate() enables N-way replay

    @property
    def image_hw(self):
        return tuple(self.manifest["image_hw"])

    def replicate(self, devices=None):
        """Data-parallel replay: a copy of every program on each device
        (default: every card when the artifact runs on CUDA); batch replay
        then round-robins bucket-size chunks over the replicas, one chunk
        in flight on each, and collects them in order, so the outputs equal
        single-device replay. With fewer than two devices it warns and
        keeps one replica."""
        if devices is None:
            devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                       if self.device.type == "cuda" else [self.device])
        devices = [torch.device(d) for d in devices]
        if len(devices) < 2:
            logger.warning(
                "data-parallel artifact replay requested but only %d "
                "device(s); running one replica", len(devices))
            self._replicas = None
            return self
        for d in devices:
            if d.type != self.device.type:
                raise ValueError(f"replica device {d} is not of the class "
                                 f"the artifact runs on ({self.device.type})")
        self._replicas = [(d, {b: (self._programs[b]
                                   if d == self.device else
                                   _moved(p, d).module())
                               for b, p in self._exported.items()})
                          for d in devices]
        logger.info("artifact replicated over %d device(s)", len(devices))
        return self

    def _replay(self, programs, device, images_u8):
        """Enqueue one bucket-size batch (a uint8 tensor on any device) on
        `device`; returns its output tensors there (not synchronised)."""
        x = images_u8.to(device)
        # TF32 off, as the live float32 forward runs (a bf16 program has no
        # float32 conv or matmul for it to change)
        with torch.no_grad(), _no_tf32(True):
            return tuple(programs[images_u8.shape[0]](x))

    def _dispatch_chunk(self, images_u8, replica=None):
        batch = images_u8.shape[0]
        bucket = next(b for b in self._buckets if b >= batch)
        pad = bucket - batch
        if pad:
            images_u8 = torch.cat([images_u8,
                                   images_u8[-1:].repeat((pad, 1, 1, 1))])
        device, programs = replica or (self.device, self._programs)
        return self._replay(programs, device, images_u8), batch

    @staticmethod
    def _collect_chunk(handle):
        outs, batch = handle
        return [o.cpu().numpy()[:batch] for o in outs]

    def __call__(self, images_u8):
        """Outputs of (B, H, W, 3) uint8 tiles: a host array, or a tensor
        on any device (the decoder's device batch)."""
        images_u8 = _as_tiles(images_u8)
        if images_u8.ndim != 4 or images_u8.shape[-1] != 3 \
                or images_u8.shape[0] == 0:
            raise ValueError(f"expected non-empty (B, H, W, 3) uint8, got "
                             f"{tuple(images_u8.shape)}")
        if images_u8.shape[1:3] != self.image_hw:
            raise ValueError(
                f"artifact expects {self.image_hw} tiles, got "
                f"{tuple(images_u8.shape[1:3])} (resize on host first)")
        top = self._buckets[-1]
        replicas = self._replicas or [None]
        chunks = []
        inflight = deque()
        for j, i in enumerate(range(0, images_u8.shape[0], top)):
            inflight.append(self._dispatch_chunk(
                images_u8[i:i + top], replicas[j % len(replicas)]))
            if len(inflight) > len(replicas):
                chunks.append(self._collect_chunk(inflight.popleft()))
        while inflight:
            chunks.append(self._collect_chunk(inflight.popleft()))
        outs = [np.concatenate(parts) for parts in zip(*chunks)]
        max_inst = int(self.manifest["max_instances"])
        counts = outs[0].max(axis=(1, 2, 3), initial=0)
        if counts.max(initial=0) > max_inst and not self._warned_overflow:
            self._warned_overflow = True
            logger.warning(
                "artifact serve: component count %d exceeds the exported "
                "instance pad %d; tail instances dropped (a live FusedServe "
                "escalates: export with a wider max_instances for such "
                "scenes)", int(counts.max()), max_inst)
        return tuple(outs)

    # the daemon's dispatch/collect protocol (FusedServe's): dispatch
    # enqueues a batch of exactly one bucket's size, collect copies back
    def dispatch(self, images_u8):
        images_u8 = _as_tiles(images_u8)
        batch = images_u8.shape[0]
        if batch not in self._programs:
            raise ValueError(f"no exported program for batch {batch}; "
                             f"buckets: {self._buckets}")
        return self._replay(self._programs, self.device, images_u8)

    def collect(self, handle):
        return tuple(o.cpu().numpy() for o in handle)

    def converter(self):
        """convert(image_id, outs, i) -> annotations for image i of a
        collected batch (the Microbatcher protocol), or None for the plain
        labels/scores conversion. A scoring export rescores each image's
        instances with the bundled GBM on the features output, then runs
        the cross-layer NMS."""
        if not self.manifest.get("scoring_model"):
            return None
        from mapping_tpu_torch.infer.daemon import scoring_convert_fn
        from mapping_tpu_torch.scoring import ScoringGBM

        model = ScoringGBM().load(os.path.join(self._dir, _SCORING_MODEL))
        return scoring_convert_fn(
            model, self.manifest["category_layers"],
            self.manifest["nms_iou_threshold"],
            emit_suppressed=bool(self.manifest.get("emit_suppressed", 0)))

    def annotations(self, image_id: int, labels, scores,
                    category_ids=None):
        """COCO annotations for one image's outputs (the daemon's response
        conversion)."""
        from mapping_tpu_torch.constants import CATEGORY_IDS
        from mapping_tpu_torch.infer.annotations import \
            labeled_to_annotations

        return labeled_to_annotations(
            image_id, np.asarray(labels), np.asarray(scores),
            category_ids or CATEGORY_IDS,
            self.manifest["category_layers"])


def _program_device(program, default):
    """The device of a loaded program's weights (the exporting one)."""
    for tensor in program.state_dict.values():
        return tensor.device
    return default


def _moved(program, device):
    """`program` with its weights and the devices inside its graph on
    another device of the same class (cuda:0 -> cuda:1)."""
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(program, device)


def load_artifact(directory: str, device=None) -> ArtifactServe:
    """The artifact at `directory` on `device` (default: the device it was
    exported on); another device class raises."""
    if not os.path.exists(os.path.join(directory, _MANIFEST)):
        raise FileNotFoundError(
            f"no serving artifact at {directory} (missing {_MANIFEST})")
    return ArtifactServe(directory, device=device)


def predict_dir_with_artifact(artifact_dir: str, dir_path: str,
                              prediction_path: str,
                              chunk_images: int = 0,
                              data_parallel: bool = False, device=None,
                              timings=None):
    """`predict_on_dir --artifact DIR`: every image of `dir_path` through
    the artifact (no checkpoint, config or model code), COCO result
    annotations written to `prediction_path` and returned."""
    from mapping_tpu_torch.data.metadata import generate_inference_metadata

    art = load_artifact(artifact_dir, device=device)
    if data_parallel:
        art.replicate()  # one replica, with a warning, on a single card
    meta = generate_inference_metadata(images_dir=dir_path)
    if not len(meta):
        raise ValueError(f"no images found under {dir_path}")
    prediction = predict_paths_with_artifact(
        art, [row["ImageId"] for row in meta],
        [row["file_path_image"] for row in meta], chunk_images=chunk_images,
        timings=timings)
    with open(prediction_path, "w") as f:
        json.dump(prediction, f)
    logger.info("submission saved to %s", prediction_path)
    return prediction


def predict_paths_with_artifact(art: ArtifactServe, ids, paths,
                                chunk_images: int = 0, timings=None):
    """COCO result annotations for (image_id, file path) pairs through a
    loaded artifact: the engine of `predict_on_dir --artifact` and
    `evaluate --artifact`. Images decode through utils/native_decode (a
    JPEG's Huffman decode on the host, its pixel stage on the artifact's
    device, on a stream of its own on a card) and are resized to the
    artifact's tile on the host when they differ (utils/resize); chunk
    k + 1 decodes on a look-ahead thread while chunk k runs. `timings`
    gets the seconds of decode (on that thread, to the pixel stage's
    end), device (the replay, copies included) and annotation + RLE (with
    the scoring rescore and NMS of a scoring artifact)."""
    from mapping_tpu_torch.constants import CATEGORY_IDS
    from mapping_tpu_torch.infer.annotations import labeled_to_annotations
    from mapping_tpu_torch.utils import native_decode

    timings = {} if timings is None else timings
    convert = art.converter()
    h, w = art.image_hw
    ids = list(ids)
    paths = list(paths)
    # decode per chunk so host memory stays bounded on large directories
    chunk = int(chunk_images) or 4 * max(art.manifest["batch_buckets"])
    decode_s = device_s = annotation_s = 0.0

    decoder = native_decode.DeviceDecoder(art.device)

    def _decode_chunk(start):
        begin = time.perf_counter()
        chunk_paths = paths[start:start + chunk]
        workers = min(8, os.cpu_count() or 1)
        # threads only where the decoder releases the GIL (the loader's
        # rule, data/loader.SegmentationLoader._decode_many)
        if len(chunk_paths) <= 1 or workers <= 1 or not all(
                native_decode.releases_gil(p) for p in chunk_paths):
            items = [native_decode.read_image(p) for p in chunk_paths]
        else:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                items = list(ex.map(native_decode.read_image, chunk_paths))
        images, ready = decoder(items, (h, w))
        return images, ready, time.perf_counter() - begin

    prediction = []
    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="artifact-decode") as ahead:
        future = ahead.submit(_decode_chunk, 0)
        for start in range(0, len(paths), chunk):
            images, ready, seconds = future.result()
            images = native_decode.take(images, ready)
            decode_s += seconds
            if start + chunk < len(paths):
                future = ahead.submit(_decode_chunk, start + chunk)
            begin = time.perf_counter()
            outs = art(images)
            device_s += time.perf_counter() - begin
            begin = time.perf_counter()
            for i, image_id in enumerate(ids[start:start + chunk]):
                if convert is not None:
                    prediction.extend(convert(int(image_id), outs, i))
                else:
                    prediction.extend(labeled_to_annotations(
                        int(image_id), outs[0][i], outs[1][i], CATEGORY_IDS,
                        art.manifest["category_layers"]))
            annotation_s += time.perf_counter() - begin
            logger.info("predicted %d/%d images",
                        min(start + chunk, len(paths)), len(paths))
    timings.update(images=len(paths), decode_s=decode_s, device_s=device_s,
                   annotation_s=annotation_s)
    return prediction
