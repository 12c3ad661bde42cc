"""Host time of decoding a JPEG tile on the CPU: the port's decoder against
libjpeg.

    python3 -m mapping_tpu_torch.tools.decode_timing [--tiles 160]

`--tiles` 300^2 tiles of the synthetic split's kind (scale_rehearsal's
`make_image`, seeded), written by `utils/jpeg.encode` at quality 95, 4:2:0
(the repo's own JPEG tiles), decoded from memory. Reported in ms a tile on
the host clock, the best of `--repeats` passes over all tiles, on 1 thread
and on 8:
- huffman: `utils/jpeg.read_coefficients` alone (the markers and the C++
  Huffman decode), the host half of the decode on every machine;
- port: `native_decode.decode_rgb_bytes`, the Huffman decode and the plain
  PyTorch pixel stage, the whole decode of one tile on the CPU; on 8
  threads each takes whole tiles, torch on one thread;
- port_batch: batches of 20 as the loader decodes them on the CPU: the
  Huffman decodes (on the threads), then one plain pixel-stage call a batch
  (`native_decode.assemble`), torch on as many threads;
- libjpeg: cpp/decode.cpp's in-memory decode (libjpeg-turbo's default
  decode, which the JAX package uses) where that library builds, else
  null.
Raises unless the port's decode equals libjpeg's on every tile. Prints one
JSON line.
"""

import argparse
import ctypes
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mapping_tpu_torch.tools.scale_rehearsal import make_image
from mapping_tpu_torch.utils import jpeg, native_decode
from mapping_tpu_torch.utils.native_lib import NativeLibraryUnavailable

TILE = 300
BATCH = 20


def libjpeg_decoder():
    """bytes -> (H, W, 3) uint8 through cpp/decode.cpp's libjpeg, or None
    where that library does not build."""
    try:
        lib = native_decode.load()
    except NativeLibraryUnavailable:
        return None

    def decode(data):
        h, w = ctypes.c_int(), ctypes.c_int()
        if lib.decode_probe_mem(data, len(data), ctypes.byref(h),
                                ctypes.byref(w)) != 0:
            raise ValueError("libjpeg cannot read the tile")
        out = np.empty((h.value, w.value, 3), np.uint8)
        if lib.decode_image_mem(data, len(data),
                                out.ctypes.data_as(ctypes.c_char_p),
                                out.nbytes, 3) != 0:
            raise ValueError("libjpeg cannot decode the tile")
        return out

    return decode


def best_ms(run, units, repeats):
    """The best of `repeats` calls of run(), in ms per unit."""
    best = float("inf")
    for _ in range(repeats):
        start = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - start)
    return best / units * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", type=int, default=160)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    blobs = [jpeg.encode(make_image(rng, TILE, TILE)[0], quality=95,
                         sampling="4:2:0") for _ in range(args.tiles)]
    libjpeg = libjpeg_decoder()
    if libjpeg is not None:
        for b in blobs:
            if not np.array_equal(native_decode.decode_rgb_bytes(b),
                                  libjpeg(b)):
                raise AssertionError("the port's decode differs from "
                                     "libjpeg's")
    batches = [blobs[i:i + BATCH] for i in range(0, len(blobs), BATCH)]
    default_threads = torch.get_num_threads()

    def per_tile(fn, workers):
        if workers == 1:
            return lambda: [fn(b) for b in blobs]
        return lambda: list(pool.map(fn, blobs))

    def batched(workers):
        def run():
            for chunk in batches:
                items = (list(pool.map(native_decode.read_bytes, chunk))
                         if workers > 1 else
                         [native_decode.read_bytes(b) for b in chunk])
                native_decode.assemble(items, "cpu")
        return run

    out = {}
    with ThreadPoolExecutor(8) as pool:
        for workers in (1, 8):
            torch.set_num_threads(1)
            cases = {"huffman": per_tile(jpeg.read_coefficients, workers),
                     "port": per_tile(native_decode.decode_rgb_bytes,
                                      workers)}
            if libjpeg is not None:
                cases["libjpeg"] = per_tile(libjpeg, workers)
            for name, run in cases.items():
                out.setdefault(name, {})[str(workers)] = best_ms(
                    run, len(blobs), args.repeats)
            out.setdefault("libjpeg", {}).setdefault(str(workers), None)
            torch.set_num_threads(workers)
            out.setdefault("port_batch", {})[str(workers)] = best_ms(
                batched(workers), len(blobs), args.repeats)
    torch.set_num_threads(default_threads)
    print(json.dumps({"tile": [TILE, TILE], "quality": 95,
                      "sampling": "4:2:0", "tiles": len(blobs),
                      "mean_bytes": float(np.mean([len(b) for b in blobs])),
                      "cpus": os.cpu_count(), "ms_per_tile": out,
                      "equal_to_libjpeg": libjpeg is not None}))


if __name__ == "__main__":
    main()
