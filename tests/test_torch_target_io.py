"""The target files: the port's PNG writer and pickle reader/writer, and
overlay_masks / prepare_masks against the JAX package's files.

The files follow the JAX layout, {target_dir}/{split}/masks/{stem}.png (8-bit
grey) and distances/ and sizes/ pickles without extension. The port writes
the pickles with the standard library and reads joblib's format without
joblib (utils/ndpickle.py).

Tolerances: all exact. overlay_masks runs on axis-aligned rectangles (the
synthetic fixture's buildings and small hand-made splits), where the two
packages' polygon fills agree pixel for pixel; the decoded files are
equal, the JAX `load_target` reads the port's files equal to its own, and
the port's `load_target` reads the JAX package's files equal to the JAX
`load_target`.
"""

import importlib
import json
import os
import pickle
from pathlib import Path

import joblib
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from mapping_tpu.data.loader import load_target as jax_load_target
from mapping_tpu.manager import PipelineManager as JaxManager
from mapping_tpu_torch import main as cli
from mapping_tpu_torch.data.loader import load_target
from mapping_tpu_torch.prep import targets
from mapping_tpu_torch.utils import ndpickle, png
from tests.fixtures.synthetic import generate

jax_targets = importlib.import_module("mapping_tpu.prep.targets")

torch.set_num_threads(2)

SUBDIRS = ("masks", "distances", "sizes")


# ------------------------------------------------------------------- PNG

def test_png_gray_round_trip(tmp_path):
    mask = np.random.RandomState(0).randint(0, 4, (37, 53)).astype(np.uint8)
    path = tmp_path / "m.png"
    png.write_png_gray(path, mask)
    np.testing.assert_array_equal(png.read_png_gray(path), mask)
    with Image.open(path) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.asarray(im), mask)
    with pytest.raises(ValueError, match="needs"):
        png.write_png_gray(tmp_path / "x.png", np.zeros((4, 4, 3), np.uint8))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_gray_reader_matches_pil_convert_l(tmp_path, mode):
    """PIL-written files (PIL picks the row filters) read as PIL's
    convert("L") reads them."""
    rng = np.random.RandomState(1)
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    pixels = rng.randint(0, 256, (21, 34, channels)).astype(np.uint8)
    path = tmp_path / f"{mode}.png"
    Image.fromarray(pixels[..., 0] if channels == 1 else pixels,
                    mode).save(path)
    with Image.open(path) as im:
        want = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(png.read_png_gray(path), want)


def test_png_rgb_writer_reads_back_in_pil(tmp_path):
    rgb = np.random.RandomState(2).randint(0, 256, (19, 23, 3)).astype(
        np.uint8)
    path = tmp_path / "rgb.png"
    path.write_bytes(png.encode_png(rgb))
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), rgb)
    np.testing.assert_array_equal(png.read_png_rgb(path), rgb)


# ---------------------------------------------------------------- pickles

ARRAYS = {"float16": np.arange(35, dtype=np.float16).reshape(5, 7) / 3,
          "int32": np.arange(-10, 20, dtype=np.int32).reshape(5, 6),
          "fortran": np.asfortranarray(np.arange(12.0).reshape(3, 4)),
          "empty": np.zeros((0, 3), np.int32),
          "scalar": np.array(2.5, np.float32)}


@pytest.mark.parametrize("name", list(ARRAYS))
def test_ndpickle_round_trips_with_joblib(tmp_path, name):
    """The port's files load in joblib, joblib's own (with its alignment
    padding) load in the port, and the port reads its own; dtype, shape
    and values kept."""
    arr = ARRAYS[name]
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ndpickle.dump(arr, ours)
    joblib.dump(arr, theirs)
    for got in (joblib.load(ours), ndpickle.load(theirs),
                ndpickle.load(ours)):
        assert got.dtype == arr.dtype and got.shape == arr.shape
        np.testing.assert_array_equal(got, arr)


def test_ndpickle_reads_joblib_padding_of_any_length(tmp_path):
    """joblib aligns the array data to 16 bytes from the file's start, so
    the padding before it depends on the header: arrays of other ranks
    give padding of other lengths (1 to 16 bytes)."""
    seen = set()
    for ndim in range(1, 5):
        arr = np.arange(3, dtype=np.int32).reshape((1,) * (ndim - 1) + (3,))
        path = tmp_path / f"a{ndim}"
        joblib.dump(arr, path)
        data = path.read_bytes()
        start = len(data) - 1 - arr.nbytes  # the data, then STOP
        seen.update(k for k in range(1, 17) if data[start - k - 1] == k
                    and data[start - k:start] == b"\xff" * k)
        got = ndpickle.load(path)
        assert got.shape == arr.shape
        np.testing.assert_array_equal(got, arr)
    assert len(seen) >= 3


def test_ndpickle_refuses_what_it_does_not_read(tmp_path):
    compressed = tmp_path / "z"
    joblib.dump(np.arange(5), compressed, compress=3)
    with pytest.raises(ValueError, match="compressed"):
        ndpickle.load(compressed)
    other = tmp_path / "dict"
    other.write_bytes(pickle.dumps({"a": 1}))
    with pytest.raises(ValueError, match="not an ndarray"):
        ndpickle.load(other)
    foreign = tmp_path / "class"
    foreign.write_bytes(pickle.dumps(Path("/")))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        ndpickle.load(foreign)
    objects = tmp_path / "objects"
    joblib.dump(np.array([1, "a"], dtype=object), objects)
    with pytest.raises(ValueError, match="objects"):
        ndpickle.load(objects)


# ------------------------------------------------------ target files

def _read_files(target_dir, split):
    """{stem: (mask, distances, sizes)} decoded with PIL and joblib."""
    out = {}
    for name in sorted(os.listdir(os.path.join(target_dir, split, "masks"))):
        stem = name[:-len(".png")]
        with Image.open(os.path.join(target_dir, split, "masks", name)) as im:
            mask = np.asarray(im)
        out[stem] = (mask,) + tuple(
            joblib.load(os.path.join(target_dir, split, sub, stem))
            for sub in SUBDIRS[1:])
    return out


def assert_same_files(got_dir, want_dir, split):
    got, want = _read_files(got_dir, split), _read_files(want_dir, split)
    assert list(got) == list(want) and want
    for stem in want:
        for g, w in zip(got[stem], want[stem]):
            assert g.dtype == w.dtype and g.shape == w.shape, stem
            np.testing.assert_array_equal(g, w)
        mask_path = os.path.join(want_dir, split, "masks", stem + ".png")
        port_path = os.path.join(got_dir, split, "masks", stem + ".png")
        reference = jax_load_target(mask_path)
        np.testing.assert_array_equal(jax_load_target(port_path), reference)
        np.testing.assert_array_equal(load_target(mask_path), reference)


def _rect_poly(x0, y0, bw, bh):
    return [float(x0), float(y0), float(x0 + bw), float(y0),
            float(x0 + bw), float(y0 + bh), float(x0), float(y0 + bh)]


def write_split(root, split, tiles, size):
    """annotation.json of `tiles`, each a list of (category, x0, y0, w, h)
    rectangles, as COCO polygons on images of `size`."""
    h, w = size
    doc = {"images": [], "annotations": [],
           "categories": [{"id": c, "name": f"c{c}"} for c in (100, 200)]}
    for i, rects in enumerate(tiles):
        doc["images"].append({"id": i + 1, "file_name": f"{split}_{i:03d}.png",
                              "height": h, "width": w})
        for cat, x0, y0, bw, bh in rects:
            doc["annotations"].append({
                "id": len(doc["annotations"]) + 1, "image_id": i + 1,
                "category_id": cat, "segmentation": [_rect_poly(x0, y0, bw,
                                                                bh)],
                "area": float(bw * bh), "bbox": [x0, y0, bw, bh],
                "iscrowd": 0})
    os.makedirs(os.path.join(root, split), exist_ok=True)
    with open(os.path.join(root, split, "annotation.json"), "w") as f:
        json.dump(doc, f)


@pytest.fixture(scope="module")
def fixture_data(tmp_path_factory):
    """The synthetic fixture (6 train, 3 val tiles of 300^2, up to 6
    buildings) and the JAX package's prepare_masks of it at the defaults."""
    root = tmp_path_factory.mktemp("prep")
    generate(str(root / "data"), n_train=6, n_val=3, seed=7)
    params = {"data_dir": str(root / "data"), "meta_dir": str(root / "jax"),
              "experiment_dir": str(root / "exp")}
    path = root / "jax.yaml"
    path.write_text(yaml.safe_dump({"parameters": params}))
    JaxManager(str(path)).prepare_masks(False)
    return root


def _port_config(root, name, extra=None):
    params = {"data_dir": str(root / "data"), "meta_dir": str(root / name),
              "experiment_dir": str(root / "exp"), "device": "cpu",
              **(extra or {})}
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump({"parameters": params}))
    return str(path)


def test_prepare_masks_cli_matches_jax(fixture_data):
    """`python3 -m mapping_tpu_torch.main prepare_masks` with device cpu
    writes the train and val files the JAX package writes."""
    root = fixture_data
    cli.main(["--config", _port_config(root, "port"), "prepare_masks"])
    sub = "masks_overlayed_eroded_0_dilated_0"
    for split in ("train", "val"):
        assert_same_files(str(root / "port" / sub), str(root / "jax" / sub),
                          split)


def test_prepare_masks_dev_mode_reads_annotation_small(fixture_data):
    root = fixture_data
    small = root / "data" / "val" / "annotation-small.json"
    doc = json.loads(small.read_text())
    saved = small.read_text()
    doc["images"] = doc["images"][:1]
    try:
        small.write_text(json.dumps(doc))
        cli.main(["--config", _port_config(root, "port_dev"), "prepare_masks",
                  "-d"])
    finally:
        small.write_text(saved)
    masks = root / "port_dev" / "masks_overlayed_eroded_0_dilated_0" / "val" \
        / "masks"
    assert sorted(os.listdir(masks)) == [
        doc["images"][0]["file_name"].replace(".jpg", ".png")]


def test_prepare_masks_on_cuda_without_a_card_raises(fixture_data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config = _port_config(fixture_data, "port_cuda", {"device": "cuda"})
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--config", config, "prepare_masks"])
    assert not (fixture_data / "port_cuda").exists()  # nothing on the CPU


@pytest.mark.parametrize("rules", [
    {"erode": 3, "border_width": 2},
    {"erode": 3, "dilate": 2, "small_annotations_size": 30}])
def test_overlay_masks_modes_match_jax(fixture_data, tmp_path, rules):
    root = fixture_data
    data = str(root / "data")
    jax_targets.overlay_masks(data, "train", str(tmp_path / "jax"),
                              [None, 100], **rules)
    targets.overlay_masks(data, "train", str(tmp_path / "port"), [None, 100],
                          num_threads=3, device="cpu", **rules)
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), "train")


def _small_tiles():
    """Tiles of 48^2: a crowded one (12 buildings, over a MAX_OBJECTS
    patched to 8), an empty one, one with two touching buildings and one
    with a building in the 2-pixel frame only."""
    rng = np.random.RandomState(9)
    crowded = [(100, int(x), int(y), 4, 4)
               for y, x in rng.randint(4, 40, (12, 2))]
    return [crowded, [], [(100, 10, 10, 12, 10), (100, 22, 10, 12, 10)],
            [(100, 0, 0, 30, 2), (100, 20, 20, 9, 9)]]


@pytest.mark.parametrize("border_width", [0, 3])
def test_overlay_masks_crowded_and_empty_tiles_match_jax(
        tmp_path, monkeypatch, border_width):
    data = str(tmp_path / "data")
    write_split(data, "train", _small_tiles(), (48, 48))
    monkeypatch.setattr(jax_targets, "MAX_OBJECTS", 8)
    monkeypatch.setattr(targets, "MAX_OBJECTS", 8)
    for pkg, name in ((jax_targets, "jax"), (targets, "port")):
        extra = {"device": "cpu"} if pkg is targets else {}
        pkg.overlay_masks(data, "train", str(tmp_path / name), [None, 100],
                          erode=2, small_annotations_size=3,
                          border_width=border_width, **extra)
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), "train")
    empty = _read_files(str(tmp_path / "port"), "train")["train_001"]
    assert not empty[0].any() and not empty[1].any() and (empty[2] == 1).all()


def test_overlay_masks_multicategory_matches_jax(tmp_path):
    """Two categories: later ones win where masks overlap; distances and
    sizes over every object; the border class once on the final mask."""
    data = str(tmp_path / "data")
    write_split(data, "train", [
        [(100, 8, 8, 8, 8), (200, 28, 30, 12, 10)],
        [(100, 5, 5, 20, 20), (200, 15, 15, 20, 20), (100, 36, 4, 6, 6)],
        [(200, 10, 10, 5, 5)], []], (48, 48))
    for pkg, name in ((jax_targets, "jax"), (targets, "port")):
        extra = {"device": "cpu"} if pkg is targets else {}
        pkg.overlay_masks(data, "train", str(tmp_path / name),
                          [None, 100, 200], border_width=2, **extra)
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), "train")
