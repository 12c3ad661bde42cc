"""The port's host layers against the JAX package, on the same inputs.

Decode, RLE, the COCO index and evaluator, the annotation writer, the
metadata tables and sampling, the config reader and the checkpoint
readers. Tolerances: everything exact (byte-exact RLE strings, equal
dicts, equal stats, equal arrays), except the polygon fill on polygons
that are not axis-aligned rectangles, where differing pixels must lie on
the polygon's boundary ring.
"""

import io
import json
import os
import shutil
import struct
import zlib

import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from PIL import Image
from scipy import ndimage

import jax.numpy as jnp

from mapping_tpu import config as jax_config
from mapping_tpu import manager as jax_manager
from mapping_tpu.data import metadata as jax_metadata
from mapping_tpu.data.coco import COCOIndex as JaxCOCOIndex
from mapping_tpu.data.loader import load_image as jax_load_image
from mapping_tpu.eval import cocoeval as jax_cocoeval
from mapping_tpu.infer import annotations as jax_annotations
from mapping_tpu.ops import rle as jax_rle
from mapping_tpu.utils import native as jax_native
from mapping_tpu_torch import config, manager
from mapping_tpu_torch.data import metadata
from mapping_tpu_torch.data.coco import COCOIndex
from mapping_tpu_torch.data.loader import load_image
from mapping_tpu_torch.eval import cocoeval
from mapping_tpu_torch.infer import annotations
from mapping_tpu_torch.ops import rle
from mapping_tpu_torch.train import checkpoint
from mapping_tpu_torch.train.trainer import UNetTrainer
from mapping_tpu_torch.utils import native, native_decode, png
from mapping_tpu_torch.utils.native_lib import (NativeLib,
                                                NativeLibraryUnavailable)
from tests.fixtures.synthetic import generate_split

torch.set_num_threads(2)

CATEGORY_IDS = [None, 100]


@pytest.fixture(scope="module")
def val_split(tmp_path_factory):
    """4 synthetic CrowdAI-style val tiles (JPEG) with their COCO GT."""
    root = tmp_path_factory.mktemp("host")
    gt = generate_split(str(root), "val", 4, seed=3, max_buildings=8)
    return {"root": str(root), "gt": gt,
            "images": sorted(str(p) for p in (root / "val" / "images")
                             .iterdir())}


# ------------------------------------------------------------------ decode

def test_jpeg_decode_matches_jax(val_split):
    """The port's build of cpp/decode.cpp = the JAX load_image, exact."""
    for path in val_split["images"]:
        got, want = load_image(path), jax_load_image(path)
        assert got.dtype == np.uint8 and got.shape == (300, 300, 3)
        np.testing.assert_array_equal(got, want)


def _encode_png(pixels, filters):
    """A PNG of (H, W, C) uint8 `pixels`, row y filtered with
    filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, c = pixels.shape
    rows = pixels.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for y in range(h):
        kind = filters[y % len(filters)]
        x = rows[y]
        a = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        b = rows[y - 1] if y else np.zeros_like(x)
        cc = np.concatenate([np.zeros(c, np.int64), b[:-c]])
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        pred = [np.zeros_like(x), a, b, (a + b) // 2, paeth][kind]
        out.append(kind)
        out += ((x - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode,channels", [("RGB", 3), ("RGBA", 4),
                                           ("L", 1), ("LA", 2)])
def test_png_reader_matches_pil(tmp_path, mode, channels):
    """Every row filter, on grey, grey+alpha, RGB and RGBA: the stdlib
    reader's samples and its RGB equal PIL's, exact."""
    rng = np.random.RandomState(channels)
    yy, xx = np.mgrid[:37, :41]
    smooth = (yy * 5 + xx * 3) % 256
    pixels = np.stack([smooth, rng.randint(0, 256, smooth.shape),
                       255 - smooth, (smooth * 7) % 256], -1)[..., :channels]
    pixels = pixels.astype(np.uint8)
    data = _encode_png(pixels, filters=(0, 1, 2, 3, 4))
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == mode
        want = np.asarray(im).reshape(pixels.shape)
        want_rgb = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(want, pixels)
    np.testing.assert_array_equal(png.decode_png(data), pixels)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(png.read_png_rgb(path), want_rgb)
    np.testing.assert_array_equal(load_image(path), want_rgb)  # native


def test_png_reader_refuses_other_formats():
    """What no PNG is: a bit depth the colour type does not have (16-bit
    RGB, once refused here, is read since every PNG kind is; see
    tests/test_torch_png.py), and an unknown interlace method."""
    data = bytearray(_encode_png(np.zeros((2, 2, 3), np.uint8), (0,)))
    data[24] = 4  # bit depth 4 with colour type 2 (RGB)
    with pytest.raises(ValueError, match="bad PNG: bit depth 4"):
        png.decode_png(bytes(data))
    data[24], data[28] = 8, 2  # interlace method 2
    with pytest.raises(ValueError, match="bad PNG header"):
        png.decode_png(bytes(data))


def test_without_native_decoder_png_decodes_and_jpeg_raises(val_split,
                                                             tmp_path,
                                                             monkeypatch):
    """Without libjpeg / libpng (as on the card's machine) a PNG goes
    through the stdlib reader and decodes the same, and a JPEG decodes
    through the port's own decoder, equal to the JAX package's libjpeg
    decode; bytes that are neither still raise."""
    png_path = tmp_path / "tile.png"
    Image.fromarray(jax_load_image(val_split["images"][0])).save(png_path)
    native_rgb = load_image(png_path)

    def unavailable():
        raise NativeLibraryUnavailable("libjpeg headers missing")

    monkeypatch.setattr(native_decode, "load", unavailable)
    np.testing.assert_array_equal(load_image(png_path), native_rgb)
    for path in val_split["images"]:
        np.testing.assert_array_equal(load_image(path), jax_load_image(path))
    other = tmp_path / "tile.gif"
    other.write_bytes(b"GIF89a" + bytes(64))
    with pytest.raises(ValueError, match="not a JPEG or PNG"):
        load_image(other)


def test_native_library_that_fails_to_build_raises():
    lib = NativeLib("rle.cpp", "rle_unlinkable", lambda lib: None,
                    link=("-lno_such_library_here",))
    assert not lib.available()
    with pytest.raises(NativeLibraryUnavailable, match="no_such_library"):
        lib.load()


# --------------------------------------------------------------------- RLE

def _masks(seed, n=6, h=37, w=29):
    rng = np.random.RandomState(seed)
    out = [(rng.rand(h, w) > 0.6).astype(np.uint8) for _ in range(n - 2)]
    return out + [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8)]


@pytest.mark.parametrize("numpy_path", [False, True])
def test_rle_matches_jax_byte_exact(monkeypatch, numpy_path):
    """encode, counts strings, decode, area, to_bbox, iou and merge, with
    the C++ library and with the numpy code the library is held to."""
    if numpy_path:
        monkeypatch.setattr(rle._native, "available", lambda: False)
        monkeypatch.setattr(jax_rle, "_native", None)
    else:
        assert native.available()
        # the JAX package's library too: a worker whose first load lost
        # the build race of its one cpp/librle.so.tmp keeps its numpy
        # path; build() loads the library again (and resets that)
        if not jax_native.available():
            assert jax_native.build()
        assert jax_rle._native is jax_native and jax_native.available()
    masks = _masks(0)
    got = [rle.encode(m) for m in masks]
    want = [jax_rle.encode(m) for m in masks]
    assert got == want
    for g, w in zip(got, want):
        assert rle.string_to_counts(g["counts"]) == \
            jax_rle.string_to_counts(w["counts"])
        assert rle.counts_to_string(rle.string_to_counts(g["counts"])) == \
            g["counts"]
        np.testing.assert_array_equal(rle.decode(g), jax_rle.decode(w))
        assert rle.area(g) == jax_rle.area(w)
        assert rle.to_bbox(g) == jax_rle.to_bbox(w)
    crowd = [0, 1, 0, 0, 1, 0]
    np.testing.assert_array_equal(rle.iou(got[:4], got, crowd),
                                  jax_rle.iou(want[:4], want, crowd))
    assert rle.merge(got[:3]) == jax_rle.merge(want[:3])
    assert rle.merge(got[:3], intersect=True) == \
        jax_rle.merge(want[:3], intersect=True)


def _pil_polygon_mask(poly, h, w):
    """The JAX package's rasteriser (mapping_tpu/ops/rle.py from_polygons)
    as a mask."""
    return jax_rle.decode(jax_rle.from_polygons([poly], h, w)[0])


def test_polygon_fill_exact_on_rectangles(val_split):
    rng = np.random.RandomState(0)
    polys = [a["segmentation"][0] for a in
             json.load(open(val_split["gt"]))["annotations"]]
    for _ in range(50):
        x0, y0 = rng.randint(-5, 280, 2)
        bw, bh = rng.randint(1, 60, 2)
        polys.append([float(v) for v in (x0, y0, x0 + bw, y0, x0 + bw,
                                         y0 + bh, x0, y0 + bh)])
    for poly in polys:
        assert rle.from_polygons([poly], 300, 300) == \
            jax_rle.from_polygons([poly], 300, 300)


def test_polygon_fill_differs_only_on_the_boundary_ring():
    """Random star-shaped polygons: every pixel that differs from PIL's
    fill lies on the boundary ring (within one pixel of PIL's mask edge).
    The count is reported on failure."""
    rng = np.random.RandomState(1)
    differing, total = 0, 0
    for _ in range(60):
        n = rng.randint(3, 12)
        centre = rng.uniform(20, 280, 2)
        angle = np.sort(rng.uniform(0, 2 * np.pi, n))
        radius = rng.uniform(2, 50, n)
        poly = np.stack([centre[0] + radius * np.cos(angle),
                         centre[1] + radius * np.sin(angle)], 1).ravel()
        want = _pil_polygon_mask(poly.tolist(), 300, 300).astype(bool)
        got = rle.polygon_mask(poly, 300, 300).astype(bool)
        ring = ndimage.binary_dilation(want) & ~ndimage.binary_erosion(want)
        diff = got != want
        assert not (diff & ~ring).any(), int((diff & ~ring).sum())
        differing += int(diff.sum())
        total += int(want.sum())
    assert differing <= total * 1e-3, (differing, total)


def test_native_rle_equals_numpy():
    rng = np.random.RandomState(2)
    labels = (rng.rand(50, 60) * 7).astype(np.int32) \
        * (rng.rand(50, 60) > 0.5)
    packed = native.rle_instances(labels, 7)
    for i, (counts, bbox) in enumerate(packed, start=1):
        r = rle.encode(labels == i)
        assert counts == r["counts"] and bbox == rle.to_bbox(r)


# ------------------------------------------- COCO index, annotations, eval

def _perturbed_labels(coco, image_id, rng):
    """(2, 300, 300) int32 labels from the image's GT masks: some kept,
    some shifted or eroded, one dropped, one false positive."""
    labels = np.zeros((2, 300, 300), np.int32)
    anns = coco.load_anns(coco.get_ann_ids(img_ids=[image_id]))
    k = 0
    for i, ann in enumerate(anns):
        m = coco.ann_to_mask(ann).astype(bool)
        if i == 1:
            continue  # a missed building
        if i % 3 == 2:
            m = np.roll(m, rng.randint(3, 12), axis=1)
        elif i % 3 == 0:
            m = ndimage.binary_erosion(m, iterations=rng.randint(1, 4))
        k += 1
        labels[1][m & (labels[1] == 0)] = k
    labels[1, 280:290, 280:295] = k + 1  # a false positive
    return labels


def test_coco_index_annotations_and_eval_match_jax(val_split, tmp_path):
    gt_path = val_split["gt"]
    coco, jax_coco = COCOIndex(gt_path), JaxCOCOIndex(gt_path)
    assert coco.get_img_ids() == jax_coco.get_img_ids()
    for ann in jax_coco.anns.values():
        assert coco.ann_to_rle(ann) == jax_coco.ann_to_rle(ann)
    rng = np.random.RandomState(4)
    ids = coco.get_img_ids()
    labels = np.stack([_perturbed_labels(jax_coco, i, rng) for i in ids])
    scores = rng.rand(len(ids), 2, 256).astype(np.float32)
    got = annotations.create_annotations(ids, labels, scores, CATEGORY_IDS,
                                         (1, 1))
    want = jax_annotations.create_annotations(ids, labels, scores,
                                              CATEGORY_IDS, (1, 1))
    assert got == want and len(got) > 8
    assert got == sum((annotations.labeled_to_annotations(
        i, l, s, CATEGORY_IDS, (1, 1)) for i, l, s in zip(ids, labels,
                                                           scores)), [])
    pred = tmp_path / "prediction.json"
    pred.write_text(json.dumps(got))
    assert coco.load_res(str(pred)).dataset == \
        jax_coco.load_res(str(pred)).dataset

    def stats(module, index_cls):
        index = index_cls(gt_path)
        ev = module.COCOEvaluator(index, index.load_res(str(pred)))
        ev.evaluate()
        ev.accumulate()
        return ev.summarize(verbose=False)

    s_port, s_jax = stats(cocoeval, COCOIndex), stats(jax_cocoeval,
                                                      JaxCOCOIndex)
    np.testing.assert_array_equal(s_port, s_jax)
    assert 0.2 < s_port[0] < 1.0 and 0.2 < s_port[3] < 1.0
    assert cocoeval.coco_evaluation(gt_path, str(pred), ids, [100],
                                    verbose=False) == \
        jax_cocoeval.coco_evaluation(gt_path, str(pred), ids, [100],
                                     verbose=False)


def test_ground_truth_as_predictions_scores_one(val_split, tmp_path):
    """The split's GT written as predictions (score 1) -> AP = AR = 1."""
    coco = COCOIndex(val_split["gt"])
    dets = [{"image_id": a["image_id"], "category_id": a["category_id"],
             "score": 1.0, "segmentation": {
                 k: (v.decode() if isinstance(v, bytes) else v)
                 for k, v in coco.ann_to_rle(a).items()}}
            for a in coco.anns.values()]
    pred = tmp_path / "gt_pred.json"
    pred.write_text(json.dumps(dets))
    ap, ar = cocoeval.coco_evaluation(val_split["gt"], str(pred),
                                      coco.get_img_ids(), [100],
                                      verbose=False)
    assert ap == ar == 1.0


def test_clamped_instances_warn_like_jax(caplog):
    labels = np.zeros((2, 8, 8), np.int32)
    labels[1, :4, :4], labels[1, 5:, 5:] = 1, 2
    scores = [[], [0.5]]  # one score slot for two instances
    got = annotations.labeled_to_annotations(3, labels, scores, CATEGORY_IDS,
                                             (1, 1))
    assert got == jax_annotations.labeled_to_annotations(
        3, labels, scores, CATEGORY_IDS, (1, 1))
    assert len(got) == 1 and "dropping the tail" in caplog.text
    suppressed = annotations.labeled_to_annotations(
        3, labels, [[], [0.0, 0.5]], CATEGORY_IDS, (1, 1),
        emit_suppressed=False)
    assert [a["score"] for a in suppressed] == [0.5]


# ---------------------------------------------------------------- metadata

@pytest.mark.parametrize("n", [1, 3, 7, 12, 40])
def test_sample_matches_pandas(n):
    rows = [{"ImageId": i * 3 + 1, "is_valid": 1} for i in range(12)]
    want = jax_manager._sample(pd.DataFrame(rows), n, 1234)
    got = manager._sample(rows, n, 1234)
    assert [r["ImageId"] for r in got] == want["ImageId"].tolist()


def test_metadata_csv_matches_jax(val_split, tmp_path):
    root = val_split["root"]
    generate_split(root, "train", 2, seed=5)
    meta_dir = tmp_path / "meta"
    (meta_dir / "masks_overlayed_eroded_0_dilated_0").mkdir(parents=True)
    kw = dict(data_dir=root, meta_dir=str(meta_dir),
              masks_overlayed_prefix="masks_overlayed")
    jax_path, port_path = tmp_path / "jax.csv", tmp_path / "port.csv"
    jax_metadata.generate_metadata(**kw).to_csv(jax_path, index=None)
    metadata.write_metadata(metadata.generate_metadata(**kw), port_path)
    assert port_path.read_bytes() == jax_path.read_bytes()
    back = metadata.read_metadata(port_path)
    frame = pd.read_csv(jax_path)
    assert [r["ImageId"] for r in back] == frame["ImageId"].tolist()
    assert [r["is_valid"] for r in back] == frame["is_valid"].tolist()
    assert list(back[0]) == list(frame.columns)
    images = os.path.join(root, "val", "images")
    jax_path, port_path = tmp_path / "jax_inf.csv", tmp_path / "port_inf.csv"
    jax_metadata.generate_inference_metadata(images).to_csv(jax_path,
                                                            index=None)
    metadata.write_metadata(metadata.generate_inference_metadata(images),
                            port_path)
    assert port_path.read_bytes() == jax_path.read_bytes()


# ------------------------------------------------------------------ config

def test_default_params_equal_jax():
    assert config.DEFAULT_PARAMS == jax_config.DEFAULT_PARAMS
    assert "device" not in jax_config.DEFAULT_PARAMS


NEPTUNE_LIKE = """\
project: mapping   # a comment
tags: [solution-1, 'two words']
parameters:
  # paths
  data_dir: /data/raw
  lr: 0.0005
  small: 1e-4
  gamma: 1.0
  epochs_nr: 100
  flag: yes
  off_flag: off
  category_layers: [1, 19]
  nothing:
  tilde: ~
  quoted: "a # b"
  single: 'it''s'
  pad_method: reflect  # cv2 BORDER_REFLECT_101
"""


@pytest.mark.parametrize("name", ["config.example.yaml", "neptune_like"])
def test_yaml_reader_equals_safe_load(name):
    text = NEPTUNE_LIKE if name == "neptune_like" else open(
        os.path.join(os.path.dirname(__file__), "..", name)).read()
    assert config.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n  - 2\n", "a: {b: 1}\n", "a: &x 1\n", "a: !!str 1\n",
    "a: |\n  text\n", "a:\n  b:\n    c: 1\n", "a: 0x1F\n", "a: [1, [2]]\n",
    "- 1\n"])
def test_yaml_reader_refuses_the_rest(text):
    with pytest.raises(ValueError):
        config.parse_yaml(text)


def test_build_config_matches_jax(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(open(os.path.join(os.path.dirname(__file__), "..",
                                      "config.example.yaml")).read())
    port = config.build_config(str(path), {"erode_selem_size": 3})
    want = jax_config.build_config(str(path), {"erode_selem_size": 3})
    assert port.params.pop("device") == "cuda"
    assert port == want


# ------------------------------------------------------------- checkpoints

@pytest.fixture(scope="module")
def jax_trainer_file(tmp_path_factory):
    """A JAX UNetTrainer(ResNet34) transformer cache, as `trainer.save`
    writes it."""
    from mapping_tpu.train.trainer import UNetTrainer as JaxTrainer

    root = tmp_path_factory.mktemp("ckpt")
    path = str(root / "unet.msgpack")
    trainer = JaxTrainer(
        model_params={"encoder": "ResNet34", "dtype": "float32"},
        optimizer_params={"lr": 5e-4, "gamma": 1.0, "weight_decay": 1e-4},
        loss_params={"w0": 50, "sigma": 10, "imsize": (64, 64),
                     "dice_weight": 0.2, "bce_weight": 1.0, "smooth": 1,
                     "dice_activation": "softmax"},
        training_config={"epochs": 1}, input_size=(64, 64))
    trainer.save(path)
    yield path
    shutil.rmtree(root)  # ~0.3 GB with the optimizer state


def _assert_trees_equal(got, want, where="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{where}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and \
            str(want.dtype) == "bfloat16":
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and np.shape(got) == np.shape(want), \
            where
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want, where


def test_msgpack_reader_equals_flax(jax_trainer_file):
    from flax import serialization

    data = open(jax_trainer_file, "rb").read()
    tree = checkpoint.msgpack_restore(data)
    _assert_trees_equal(tree, serialization.msgpack_restore(data))
    assert {"params", "batch_stats", "opt_state", "step"} <= set(tree)
    odd = {"scalar": np.float32(1.5), "int_scalar": np.int64(-3),
           "bf16": jnp.arange(5, dtype=jnp.bfloat16), "list": [1, -2, 3.5],
           "text": "x" * 40, "none": None, "big": 2 ** 40, "neg": -200,
           "flag": True, "empty": {}, "bytes": b"\x00\x01"}
    data = serialization.msgpack_serialize(odd)
    _assert_trees_equal(checkpoint.msgpack_restore(data),
                        serialization.msgpack_restore(data))


def test_msgpack_reader_refuses_chunked_arrays():
    from flax import serialization

    data = serialization.msgpack_serialize(
        {"a": {"__msgpack_chunked_array__": True, "shape": {"0": 1}}})
    with pytest.raises(ValueError, match="chunks"):
        checkpoint.msgpack_restore(data)


def _port_trainer():
    return UNetTrainer(
        model_params={"encoder": "ResNet34", "dtype": "float32"},
        optimizer_params={}, loss_params={"imsize": (64, 64)},
        training_config={}, input_size=(64, 64), device="cpu")


def test_trainer_loads_the_jax_cache_and_its_own(jax_trainer_file, tmp_path):
    """unet.msgpack -> state_dict_from_flax of its params and batch_stats;
    the port's own unet.pt round-trips the same weights."""
    from flax import serialization

    from mapping_tpu_torch.models.convert import state_dict_from_flax

    tree = serialization.msgpack_restore(open(jax_trainer_file, "rb").read())
    want = state_dict_from_flax(tree["params"], tree["batch_stats"], 34)
    trainer = _port_trainer().load(jax_trainer_file)
    got = trainer.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    path = str(tmp_path / "unet.pt")
    trainer.save(path)
    again = _port_trainer().load(path).state_dict()
    os.unlink(path)
    for k in want:
        assert torch.equal(again[k], got[k])


@pytest.mark.parametrize("wrapping", ["plain", "state_dict", "module"])
def test_import_torch_checkpoint_wrappings(tmp_path, wrapping):
    source = _port_trainer()
    with torch.no_grad():
        for p in source.model.parameters():
            p.add_(0.01)
    state = source.state_dict()
    payload = {"plain": state, "state_dict": {"state_dict": state,
                                              "epoch": 7},
               "module": {"module." + k: v for k, v in state.items()}}
    path = tmp_path / f"{wrapping}.pth"
    torch.save(payload[wrapping], path)
    got = _port_trainer().import_torch_checkpoint(str(path)).state_dict()
    path.unlink()
    for k, v in state.items():
        assert torch.equal(got[k], v), k


def test_import_torch_checkpoint_refuses_other_keys(tmp_path):
    state = _port_trainer().state_dict()
    state.pop("final.bias")
    torch.save(state, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="final.bias"):
        _port_trainer().import_torch_checkpoint(str(tmp_path / "bad.pth"))
    (tmp_path / "bad.pth").unlink()


def test_annotations_are_the_same_with_and_without_the_native_library(
        monkeypatch):
    """The port's RLE strings and bboxes do not depend on whether
    cpp/rle.cpp builds: the numpy writer ends a mask whose last pixel (in
    column-major order) is set with the library's empty 0-run. Label maps
    with instances on the last pixel, on the borders, a full layer and an
    empty one; the strings also equal the JAX package's with its library
    built."""
    from mapping_tpu_torch.utils import native

    for _ in range(3):  # a worker that lost the JAX package's build race
        if jax_native._lib.build():
            break
    assert jax_native._lib.available() and native.available()
    rng = np.random.RandomState(0)
    maps = []
    for seed in range(40):
        labels, _ = ndimage.label(ndimage.gaussian_filter(
            rng.rand(37, 29), 1.5) > 0.5)
        if seed % 2:
            labels[-1, -1] = max(labels[-1, -1], 1)
        maps.append(labels)
    maps += [np.ones((5, 4), np.int32), np.zeros((6, 6), np.int32)]
    labels = np.stack([np.stack([m, m]) for m in maps[:-2]])
    cases = [(labels[i], np.linspace(0.1, 1, 128)[None].repeat(2, 0))
             for i in range(len(labels))]
    cases += [(m[None].repeat(2, 0), np.full((2, 3), 0.5)) for m in maps[-2:]]

    def run():
        return [annotations.labeled_to_annotations(
            i, lab, sc, [None, 100], [1, 1]) for i, (lab, sc) in
            enumerate(cases)]

    built = run()
    monkeypatch.setattr(native, "available", lambda: False)
    assert run() == built
    assert sum(len(a) for a in built) > 100
    want = [jax_annotations.labeled_to_annotations(
        i, lab, sc, [None, 100], [1, 1]) for i, (lab, sc) in
        enumerate(cases)]
    assert built == want
