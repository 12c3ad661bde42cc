"""The port's online serving daemon (mapping_tpu_torch/infer/daemon.py)
against the JAX package's (mapping_tpu/infer/daemon.py).

Both daemons serve the stand-in probability function of
tests/test_daemon.py (channel 0 of the normalised image, scaled by 4, as
the building logit) through their own FusedServe, on the same uint8
tiles made with numpy. The tiles are 64^2 and so is the target size: the
probabilities come from uint8 values without a resize, so none lies
within float rounding of the threshold, and the annotations must agree:
segmentation, bbox, category and image id exact, scores within 1e-5
relative (JAX sums the probabilities through a bf16 hi/lo split, the port
in float64). A segmentation is compared with a trailing empty 0-run
dropped on both sides, and its decoded masks must be equal: the JAX
package's C++ and numpy RLE writers differ by that run alone, and which
one it takes depends on whether its library built in the process. Every
socket binds 127.0.0.1:0, and every wait, join and request carries its
own timeout.
"""

import functools
import io
import json
import logging
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapping_tpu.config import AttrDict as JaxAttrDict
from mapping_tpu.infer import daemon as jax_daemon
from mapping_tpu.infer.annotations import \
    labeled_to_annotations as jax_labeled_to_annotations
from mapping_tpu.infer.serving import FusedServe as JaxFusedServe
from mapping_tpu_torch.config import AttrDict
from mapping_tpu_torch.infer import daemon
from mapping_tpu_torch.infer.annotations import labeled_to_annotations
from mapping_tpu_torch.infer.daemon import (Microbatcher, OverloadedError,
                                            RequestError, ServingDaemon,
                                            decode_request_image)
from mapping_tpu_torch.infer.serving import FusedServe
from mapping_tpu_torch.ops import rle as rle_ops
from mapping_tpu_torch.utils import native_decode

torch.set_num_threads(2)

CAT_IDS = [None, 100]
CAT_LAYERS = [1, 1]
HW = (64, 64)
POST = dict(target_size=HW, category_layers=(1, 1), active_layers=(1,))


def _jax_probs_fn(params, images):
    logit = images[..., 0] * params["scale"]
    return jax.nn.softmax(jnp.stack([-logit, logit], axis=-1), axis=-1)


def _jax_preprocess(u8_batch):
    return jnp.asarray(u8_batch, jnp.float32) / 255.0 * 2.0 - 1.0


def _probs_fn(images):
    logit = images[..., 0] * 4.0
    return torch.softmax(torch.stack([-logit, logit], dim=-1), dim=-1)


def _preprocess(u8_batch):
    return torch.as_tensor(np.asarray(u8_batch)).to(torch.float32) \
        / 255.0 * 2.0 - 1.0


def _images(n, h=64, w=64, seed=0):
    """Smooth uint8 tiles: 8x8 random blocks, bilinear upsampled."""
    rng = np.random.RandomState(seed)
    base = rng.rand(n, h // 8, w // 8, 3).astype(np.float32)
    up = torch.nn.functional.interpolate(
        torch.from_numpy(base).permute(0, 3, 1, 2), size=(h, w),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    return (up.numpy() * 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_serve():
    return JaxFusedServe(_jax_probs_fn, lambda: {"scale": jnp.float32(4.0)},
                         **POST)


@functools.lru_cache(maxsize=None)
def _jax_rle_library():
    """Build the JAX package's RLE library in this worker, which may have
    lost its build race to another process."""
    from mapping_tpu.utils import native as jax_native

    for _ in range(3):
        if jax_native._lib.build():
            break
    assert jax_native._lib.available()


def _expected(img_u8, image_id=0):
    """The JAX daemon's offline oracle: its FusedServe on one image."""
    _jax_rle_library()
    outs = _jax_serve()(_jax_preprocess(img_u8[None]))
    return jax_labeled_to_annotations(image_id, np.asarray(outs[0][0]),
                                      np.asarray(outs[1][0]), CAT_IDS,
                                      CAT_LAYERS)


def _canonical_counts(segmentation):
    """The run list of a compressed RLE without a trailing empty 0-run."""
    counts = list(rle_ops.string_to_counts(segmentation["counts"]))
    if len(counts) > 1 and counts[-1] == 0:
        counts.pop()
    return counts


def _assert_same_annotations(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["segmentation"]["size"] == w["segmentation"]["size"]
        assert _canonical_counts(g["segmentation"]) == \
            _canonical_counts(w["segmentation"])
        np.testing.assert_array_equal(rle_ops.decode(g["segmentation"]),
                                      rle_ops.decode(w["segmentation"]))
        assert g["category_id"] == w["category_id"]
        assert g["image_id"] == w["image_id"]
        np.testing.assert_allclose(g["bbox"], w["bbox"])
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-5)


def _serve():
    return FusedServe(_probs_fn, **POST)


def _batcher(batch_size=4, max_wait_ms=30.0, **kwargs):
    return Microbatcher(_serve(), _preprocess, batch_size,
                        category_ids=CAT_IDS, category_layers=CAT_LAYERS,
                        max_wait_ms=max_wait_ms, **kwargs)


def _run_clients(fn, n, timeout=120):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a client hung"


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.01)


def test_single_request_matches_jax():
    imgs = _images(1, seed=3)
    b = _batcher()
    try:
        got = b.submit(imgs[0], timeout=60)
    finally:
        b.close()
    _assert_same_annotations(got, _expected(imgs[0]))
    assert got and got[0]["category_id"] == 100


def test_concurrent_requests_match_the_jax_daemon():
    """8 concurrent clients on a batch-4 daemon of each package: every
    caller of the port's gets the JAX daemon's answer for ITS image, and
    the port's microbatcher forms >= 2 batches of mean occupancy > 1."""
    imgs = _images(8, seed=5)
    jax_b = jax_daemon.Microbatcher(
        _jax_serve(), _jax_preprocess, 4, category_ids=CAT_IDS,
        category_layers=CAT_LAYERS, max_wait_ms=200.0)
    b = _batcher(batch_size=4, max_wait_ms=200.0)
    results = {"jax": [None] * 8, "port": [None] * 8}

    def call(i):
        results["port"][i] = b.submit(imgs[i], timeout=120, image_id=i)
        results["jax"][i] = jax_b.submit(imgs[i], timeout=120, image_id=i)

    try:
        _run_clients(call, 8)
    finally:
        b.close()
        jax_b.close()
    for got, want in zip(results["port"], results["jax"]):
        _assert_same_annotations(got, want)
    assert b.stats["requests"] == 8
    assert b.stats["batches"] >= 2
    assert b.stats["requests"] / b.stats["batches"] > 1.0


def test_ragged_tail_pads_to_the_batch_shape():
    """3 requests on a batch-4 daemon: the last row is repeated, and the
    padded row's output is dropped."""
    imgs = _images(3, seed=7)
    b = _batcher(batch_size=4, max_wait_ms=300.0)
    results = [None] * 3

    def call(i):
        results[i] = b.submit(imgs[i], timeout=120)

    try:
        _run_clients(call, 3)
    finally:
        b.close()
    for i in range(3):
        _assert_same_annotations(results[i], _expected(imgs[i]))
    assert b.stats["images_padded"] >= 1


def test_bucket_selection_pads_to_smallest_fit():
    """Buckets [1, 4]: a lone request runs the batch-1 program (no pad); a
    burst of 3 pads to 4; both give the JAX oracle's annotations."""
    b = _batcher(batch_size=4, max_wait_ms=200.0, bucket_sizes=[1])
    imgs = _images(4, seed=21)
    results = [None] * 3
    try:
        got = b.submit(imgs[0], timeout=60)
        _assert_same_annotations(got, _expected(imgs[0]))
        assert b.stats["bucket_batches"]["1"] == 1
        assert b.stats["images_padded"] == 0

        def call(i):
            results[i] = b.submit(imgs[1 + i], timeout=120)

        _run_clients(call, 3)
    finally:
        b.close()
    for i in range(3):
        _assert_same_annotations(results[i], _expected(imgs[1 + i]))
    assert set(b.stats["bucket_batches"]) == {"1", "4"}
    dispatched = sum(int(k) * v for k, v in b.stats["bucket_batches"].items())
    assert dispatched == b.stats["requests"] + b.stats["images_padded"]


@pytest.mark.parametrize("bad", [[0], [8]])
def test_bucket_sizes_validated(bad):
    for cls, serve, pre in ((Microbatcher, _serve(), _preprocess),
                            (jax_daemon.Microbatcher, _jax_serve(),
                             _jax_preprocess)):
        with pytest.raises(ValueError, match="bucket sizes"):
            cls(serve, pre, 4, category_ids=CAT_IDS,
                category_layers=CAT_LAYERS, bucket_sizes=bad)


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_decode_npy_dtypes_match_jax():
    img = _images(1, h=32, w=32, seed=13)[0]
    for arr in (img, img.astype(np.float32) / 255.0, img.astype(np.int16)):
        body = _npy(arr)
        got = decode_request_image(body, "application/x-npy", (32, 32))
        want = jax_daemon.decode_request_image(body, "application/x-npy",
                                               (32, 32))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, img)
    for bad in (img.astype(np.float32),          # 0..255 floats
                img.astype(np.int32) - 500,      # negative ints
                img.astype(np.complex64),
                img[..., :2],                    # not 3 channels
                b"\x93NUMPYgarbage"):
        body = bad if isinstance(bad, bytes) else _npy(bad)
        with pytest.raises(RequestError):
            decode_request_image(body, "application/x-npy", (32, 32))
        with pytest.raises(jax_daemon.RequestError):
            jax_daemon.decode_request_image(body, "application/x-npy",
                                            (32, 32))


def test_decode_png_and_host_resize_match_jax():
    """PNG bytes decode byte-exact; a tile of another size is resized on
    the host to the same bytes as the JAX daemon's PIL resize."""
    from PIL import Image

    img = _images(1, h=48, w=48, seed=9)[0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    for hw in ((48, 48), (32, 32), (64, 40)):
        got = decode_request_image(buf.getvalue(), "image/png", hw)
        want = jax_daemon.decode_request_image(buf.getvalue(), "image/png",
                                               hw)
        assert got.shape == hw + (3,)
        np.testing.assert_array_equal(got, want)


def test_decode_without_the_native_decoder(monkeypatch):
    """Without the native decoder (as on the card's machine) a PNG decodes
    through the standard-library reader and a JPEG through the port's own
    decoder, equal to the JAX daemon's libjpeg decode; bytes that are
    neither are a RequestError."""
    from PIL import Image

    from mapping_tpu_torch.utils.native_lib import NativeLibraryUnavailable

    img = _images(1, h=32, w=32, seed=2)[0]
    png, jpeg = io.BytesIO(), io.BytesIO()
    Image.fromarray(img).save(png, format="PNG")
    Image.fromarray(img).save(jpeg, format="JPEG")
    want_jpeg = jax_daemon.decode_request_image(jpeg.getvalue(),
                                                "image/jpeg", (32, 32))

    def unavailable():
        raise NativeLibraryUnavailable("no decode library")

    monkeypatch.setattr(native_decode, "load", unavailable)
    np.testing.assert_array_equal(
        decode_request_image(png.getvalue(), "image/png", (32, 32)), img)
    np.testing.assert_array_equal(
        decode_request_image(jpeg.getvalue(), "image/jpeg", (32, 32)),
        want_jpeg)
    with pytest.raises(RequestError):
        decode_request_image(b"not an image", "image/png", (32, 32))


def _post(url, body, headers, timeout=120):
    req = urllib.request.Request(url, data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def test_http_round_trip_matches_the_jax_daemon():
    """/v1/health, /v1/predict (a .npy and a PNG body) and /v1/stats of
    the port's HTTP daemon; the predictions equal the JAX HTTP daemon's."""
    from PIL import Image

    imgs = _images(2, seed=11)
    png = io.BytesIO()
    Image.fromarray(imgs[1]).save(png, format="PNG")
    bodies = [(_npy(imgs[0]), {"Content-Type": "application/x-npy",
                               "X-Image-Id": "7"}),
              (png.getvalue(), {"Content-Type": "image/png",
                                "X-Image-Id": "8"})]
    jax_server = jax_daemon.ServingDaemon(
        jax_daemon.Microbatcher(_jax_serve(), _jax_preprocess, 4,
                                category_ids=CAT_IDS,
                                category_layers=CAT_LAYERS,
                                max_wait_ms=30.0),
        HW, {"batch_size": 4}, port=0)
    server = ServingDaemon(_batcher(), HW,
                           {"batch_size": 4, "image_hw": list(HW)},
                           device="cpu", port=0)
    server.start_background()
    jax_server.start_background()
    try:
        base = f"http://127.0.0.1:{server.port}"
        health = _get(base + "/v1/health")
        assert health == {"status": "ok", "batch_size": 4,
                          "image_hw": list(HW)}
        for body, headers in bodies:
            got = _post(base + "/v1/predict", body, headers)
            want = _post(f"http://127.0.0.1:{jax_server.port}/v1/predict",
                         body, headers)
            _assert_same_annotations(got["annotations"],
                                     want["annotations"])
            assert got["annotations"] and got["latency_ms"] > 0
        stats = _get(base + "/v1/stats")
        assert stats["requests"] == 2 and stats["batches"] == 2
        assert stats["mean_batch_occupancy"] == 1.0
        assert 0 < stats["latency_ms_p50"] <= stats["latency_ms_p99"]
    finally:
        server.shutdown()
        jax_server.shutdown()


def test_http_jpeg_body_matches_the_jax_daemon():
    """A JPEG body of the tile's size: the port's daemon runs its pixel
    stage on the serving device and batches the tile from there; the
    answer equals the JAX daemon's, which decodes it with libjpeg."""
    from PIL import Image

    img = _images(1, seed=19)[0]
    body = io.BytesIO()
    Image.fromarray(img).save(body, format="JPEG", quality=90)
    headers = {"Content-Type": "image/jpeg", "X-Image-Id": "3"}
    tile = decode_request_image(body.getvalue(), "image/jpeg", HW,
                                native_decode.DeviceDecoder("cpu"))
    assert isinstance(tile, torch.Tensor) and tile.dtype == torch.uint8
    np.testing.assert_array_equal(tile.numpy(),
                                  jax_daemon.decode_request_image(
                                      body.getvalue(), "image/jpeg", HW))
    jax_server = jax_daemon.ServingDaemon(
        jax_daemon.Microbatcher(_jax_serve(), _jax_preprocess, 4,
                                category_ids=CAT_IDS,
                                category_layers=CAT_LAYERS,
                                max_wait_ms=30.0),
        HW, {"batch_size": 4}, port=0)
    server = ServingDaemon(_batcher(), HW, {"batch_size": 4}, device="cpu",
                           port=0)
    server.start_background()
    jax_server.start_background()
    try:
        got = _post(f"http://127.0.0.1:{server.port}/v1/predict",
                    body.getvalue(), headers)
        want = _post(f"http://127.0.0.1:{jax_server.port}/v1/predict",
                     body.getvalue(), headers)
        assert got["annotations"]
        _assert_same_annotations(got["annotations"], want["annotations"])
    finally:
        server.shutdown()
        jax_server.shutdown()


def test_host_arrays_and_decoder_tiles_batch_together():
    """One batch of host arrays and tensor tiles (the decoder's, as a
    JPEG body leaves them): they stack on one device, and every caller
    gets the JAX oracle's answer for its image."""
    imgs = _images(4, seed=17)
    b = _batcher(batch_size=4, max_wait_ms=300.0)
    results = [None] * 4

    def call(i):
        image = imgs[i] if i % 2 else torch.from_numpy(imgs[i].copy())
        results[i] = b.submit(image, timeout=120)

    try:
        _run_clients(call, 4)
    finally:
        b.close()
    for i in range(4):
        _assert_same_annotations(results[i], _expected(imgs[i]))
    assert b.stats["requests"] / b.stats["batches"] > 1.0


def _status(url, body=None, headers=None, timeout=30):
    req = urllib.request.Request(url, data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


@pytest.mark.parametrize("case,code", [("undecodable", 400),
                                       ("bad_image_id", 400),
                                       ("unknown_get", 404),
                                       ("unknown_post", 404),
                                       ("overloaded", 429),
                                       ("timeout", 503)])
def test_http_error_codes(case, code):
    """The HTTP daemon's error answers, as the JAX handler gives them."""
    gate = threading.Event()

    def wedged(u8):
        gate.wait(timeout=60)
        return _preprocess(u8)

    wedge = case in ("overloaded", "timeout")
    b = Microbatcher(_serve(), wedged if wedge else _preprocess, 1,
                     category_ids=CAT_IDS, category_layers=CAT_LAYERS,
                     max_wait_ms=0.1, max_pending=1,
                     request_timeout=0.3 if case == "timeout" else 60.0)
    server = ServingDaemon(b, HW, {}, device="cpu", port=0)
    server.start_background()
    base = f"http://127.0.0.1:{server.port}"
    npy = {"Content-Type": "application/x-npy"}
    body = _npy(_images(1, seed=1)[0])
    pending = []
    try:
        if case == "overloaded":
            # one request wedged in the batcher, one filling the queue
            for _ in range(2):
                t = threading.Thread(target=_status, args=(
                    base + "/v1/predict", body, npy, 60))
                t.start()
                pending.append(t)
                if len(pending) == 1:
                    _wait_for(lambda: b._requests.qsize() == 0
                              and b.stats["bucket_batches"]["1"] == 1)
            _wait_for(lambda: b._requests.qsize() == 1)
        got = {
            "undecodable": lambda: _status(base + "/v1/predict",
                                           b"not an image",
                                           {"Content-Type": "image/png"}),
            "bad_image_id": lambda: _status(base + "/v1/predict", body,
                                            {**npy, "X-Image-Id": "x"}),
            "unknown_get": lambda: _status(base + "/v1/nothing"),
            "unknown_post": lambda: _status(base + "/v1/other", body, npy),
            "overloaded": lambda: _status(base + "/v1/predict", body, npy),
            "timeout": lambda: _status(base + "/v1/predict", body, npy),
        }[case]()
        assert got == code
    finally:
        gate.set()
        for t in pending:
            t.join(timeout=60)
        server.shutdown()
    assert not any(t.is_alive() for t in pending)
    if case == "overloaded":
        assert b.stats["rejected_overload"] == 1
    if case == "timeout":
        assert b.stats["timeouts"] == 1


def test_shutdown_fails_queued_requests_instead_of_hanging():
    b = _batcher(batch_size=4, max_wait_ms=10.0)
    b.submit(_images(1, seed=15)[0], timeout=60)
    results = {}

    def late_caller():
        try:
            results["out"] = b.submit(_images(1, seed=16)[0], timeout=30)
        except (RuntimeError, TimeoutError) as exc:
            results["err"] = exc

    b._stop.set()
    t = threading.Thread(target=late_caller)
    t.start()
    b.close()
    t.join(timeout=30)
    assert not t.is_alive(), "submit() hung across shutdown"
    assert "err" in results


def test_submit_has_default_timeout():
    b = _batcher()
    try:
        assert b._request_timeout == 300.0
        # serve=None crashes the batcher: an error, not a hang
        b2 = Microbatcher(None, _preprocess, 2, category_ids=CAT_IDS,
                          category_layers=CAT_LAYERS, request_timeout=0.5)
        with pytest.raises((RuntimeError, TimeoutError)):
            b2.submit(_images(1, seed=17)[0])
        b2.close()
    finally:
        b.close()


def test_per_image_convert_failure_isolated():
    """A convert exception for one image fails only that request."""
    def convert(image_id, outs, i):
        if image_id == 1:
            raise RuntimeError("boom for image 1")
        return labeled_to_annotations(image_id, np.asarray(outs[0][i]),
                                      np.asarray(outs[1][i]), CAT_IDS,
                                      CAT_LAYERS)

    imgs = _images(2, seed=11)
    b = _batcher(batch_size=2, max_wait_ms=200.0, convert=convert)
    results, errors = [None, None], [None, None]

    def call(i):
        try:
            results[i] = b.submit(imgs[i], timeout=120, image_id=i)
        except RuntimeError as exc:
            errors[i] = exc

    try:
        _run_clients(call, 2)
    finally:
        b.close()
    _assert_same_annotations(results[0], _expected(imgs[0]))
    assert errors[1] is not None and "boom" in str(errors[1])
    assert b.stats["requests"] == 2


def test_backpressure_sheds_load_past_max_pending():
    gate = threading.Event()

    def slow_preprocess(u8):
        gate.wait(timeout=60)
        return _preprocess(u8)

    b = Microbatcher(_serve(), slow_preprocess, 1, category_ids=CAT_IDS,
                     category_layers=CAT_LAYERS, max_wait_ms=1.0,
                     max_pending=2)
    imgs = _images(4, seed=13)
    results = [None] * 3
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, b.submit(imgs[i], timeout=120, image_id=i))) for i in range(3)]
    threads[0].start()
    try:
        _wait_for(lambda: b.stats["bucket_batches"]["1"] == 1)
        for t in threads[1:]:
            t.start()
        _wait_for(lambda: b._requests.qsize() >= 2)
        with pytest.raises(OverloadedError, match="queued"):
            b.submit(imgs[3], timeout=5, image_id=3)
        assert b.stats["rejected_overload"] == 1
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=60)
        b.close()
    assert all(r is not None for r in results)
    for i in range(3):
        _assert_same_annotations(results[i], _expected(imgs[i], i))


def test_backpressure_cap_is_atomic_under_flood():
    """32 threads flood submit() at once while the batcher is wedged:
    exactly max_pending are queued, the rest shed, every one counted."""
    gate = threading.Event()

    def wedged(u8):
        gate.wait(timeout=120)
        return _preprocess(u8)

    maxp, flood = 4, 32
    b = Microbatcher(_serve(), wedged, 1, category_ids=CAT_IDS,
                     category_layers=CAT_LAYERS, max_wait_ms=0.1,
                     max_pending=maxp)
    img = _images(1, seed=3)[0]
    results = {}
    lock = threading.Lock()

    def client(i):
        try:
            r = b.submit(img, timeout=120, image_id=i)
            with lock:
                results[i] = ("ok", r)
        except OverloadedError:
            with lock:
                results[i] = ("shed", None)

    t0 = threading.Thread(target=client, args=(0,))
    t0.start()
    _wait_for(lambda: b.stats["bucket_batches"]["1"] == 1)
    barrier = threading.Barrier(flood)

    def flood_client(i):
        barrier.wait(timeout=60)
        client(i)

    threads = [threading.Thread(target=flood_client, args=(i,))
               for i in range(1, flood + 1)]
    interval = __import__("sys").getswitchinterval()
    __import__("sys").setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()

        def settled():
            with lock:
                shed = sum(1 for i in results if results[i][0] == "shed")
            return shed + b._requests.qsize() >= flood

        _wait_for(settled, timeout=30)
        assert b._requests.qsize() == maxp
    finally:
        __import__("sys").setswitchinterval(interval)
        gate.set()
        t0.join(timeout=120)
        for t in threads:
            t.join(timeout=120)
        b.close()
    ok = [i for i, (s, _) in results.items() if s == "ok"]
    shed = [i for i, (s, _) in results.items() if s == "shed"]
    assert len(ok) == 1 + maxp and len(shed) == flood - maxp
    assert b.stats["rejected_overload"] == len(shed)


def test_concurrent_stress_all_requests_resolve():
    """24 clients against max_pending 6 and buckets [1, 2, 4]: every
    submit() returns or sheds, the counters reconcile, and the answers
    served match the JAX oracle."""
    b = _batcher(batch_size=4, max_wait_ms=2.0, bucket_sizes=[1, 2],
                 max_pending=6)
    n = 24
    imgs = _images(4, seed=17)
    outcomes = [None] * n

    def client(i):
        try:
            outcomes[i] = ("ok", b.submit(imgs[i % 4], timeout=120,
                                          image_id=i))
        except OverloadedError:
            outcomes[i] = ("shed", None)
        except Exception as exc:  # noqa: BLE001
            outcomes[i] = ("error", repr(exc))

    try:
        _run_clients(client, n, timeout=180)
    finally:
        b.close()
    assert all(o is not None for o in outcomes), "a request hung"
    assert not [o for o in outcomes if o[0] == "error"], outcomes
    served = [i for i, o in enumerate(outcomes) if o[0] == "ok"]
    shed = [i for i, o in enumerate(outcomes) if o[0] == "shed"]
    assert served and len(served) + len(shed) == n
    assert b.stats["requests"] == len(served)
    assert b.stats["rejected_overload"] == len(shed)
    for i in served[:4]:
        _assert_same_annotations(outcomes[i][1], _expected(imgs[i % 4], i))


def test_timeout_counted_in_stats_and_latency_window():
    gate = threading.Event()

    def wedged(u8):
        gate.wait(timeout=60)
        return _preprocess(u8)

    b = Microbatcher(_serve(), wedged, 1, category_ids=CAT_IDS,
                     category_layers=CAT_LAYERS, max_wait_ms=0.1,
                     request_timeout=0.3)
    try:
        with pytest.raises(TimeoutError):
            b.submit(_images(1, seed=9)[0], image_id=0)
        assert b.stats["timeouts"] == 1
        q = b.latency_quantiles()
        assert q and q["latency_ms_p99"] >= 250
    finally:
        gate.set()
        b.close()


def test_worker_error_counted_in_stats():
    b = Microbatcher(None, _preprocess, 2, category_ids=CAT_IDS,
                     category_layers=CAT_LAYERS, request_timeout=5.0)
    try:
        with pytest.raises((RuntimeError, TimeoutError)):
            b.submit(_images(1, seed=11)[0], image_id=0)
        assert b.stats["errors"] + b.stats["timeouts"] == 1
        assert b.param_source_stats() == {}
    finally:
        b.close()


def test_close_with_full_queue_does_not_leak_threads():
    """close() while the bounded queue is full (its wakeup sentinel
    dropped) and the batcher wedged: both worker threads still exit and
    the queued request is failed, not dropped."""
    gate = threading.Event()

    def wedged(u8):
        gate.wait(timeout=120)
        return _preprocess(u8)

    b = Microbatcher(_serve(), wedged, 1, category_ids=CAT_IDS,
                     category_layers=CAT_LAYERS, max_wait_ms=0.1,
                     max_pending=1)
    img = _images(1, seed=5)[0]
    results = {}

    def client(i):
        try:
            results[i] = ("ok", b.submit(img, timeout=30, image_id=i))
        except Exception as exc:  # noqa: BLE001 - shed or shut down
            results[i] = ("err", repr(exc))

    t0 = threading.Thread(target=client, args=(0,))
    t0.start()
    _wait_for(lambda: b.stats["bucket_batches"]["1"] == 1)
    t1 = threading.Thread(target=client, args=(1,))
    t1.start()
    _wait_for(lambda: b._requests.qsize() >= 1)
    closer = threading.Thread(target=b.close)
    closer.start()
    time.sleep(0.2)
    gate.set()
    closer.join(timeout=20)
    assert not closer.is_alive(), "close() hung"
    t0.join(timeout=10)
    t1.join(timeout=10)
    _wait_for(lambda: not any(t.is_alive() for t in b._threads), timeout=5)
    assert 1 in results and results[1][0] in ("ok", "err")


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("spec", ["", "1", "1,2,16,0", " 2 , 2,", "8",
                                  "3,1"])
def test_parse_serve_buckets_matches_jax(spec):
    """The same buckets and the same dropped-bucket warning as JAX."""
    params = {"batch_size_inference": 8, "serve_batch_buckets": spec}
    warned = []
    for module, attrdict in ((daemon, AttrDict), (jax_daemon, JaxAttrDict)):
        handler = _Capture()
        module.logger.addHandler(handler)
        try:
            buckets = module.parse_serve_buckets(attrdict(params))
        finally:
            module.logger.removeHandler(handler)
        warned.append((buckets, handler.messages))
    assert warned[0] == warned[1]
    assert warned[0][0][-1] == 8


@pytest.mark.parametrize("value", [0, 3, -1])
def test_max_pending_from_matches_jax(value):
    params = {"serve_max_pending": value}
    if value < 0:
        for module in (daemon, jax_daemon):
            with pytest.raises(ValueError, match="serve_max_pending"):
                module._max_pending_from(params)
    else:
        assert daemon._max_pending_from(params) == \
            jax_daemon._max_pending_from(params)
