"""Scale dress rehearsal of the port: the product ladder on a CrowdAI-shaped
synthetic dataset of JPEG tiles, with wall time and peak RSS per leg.

Counterpart of tools/scale_rehearsal.py. It generates >= 5k 300x300 train
tiles and >= 1k val tiles at CrowdAI-like building density (~8 a tile via
--max-buildings 20), by the rules of tests/fixtures/synthetic.py (the same
seeds, pictures, layout, `annotation.json` and `annotation-small.json`;
the package keeps its own copy of them), written as JPEG at quality 95,
4:2:0, through the port's encoder (utils/jpeg.encode), so no Pillow is
needed. Then it runs

    prepare_masks -> prepare_metadata -> train (short) ->
    evaluate -c 1000 -> evaluate (default) -> scoring train ->
    scoring evaluate -> export -> evaluate --artifact

each as a child process of `python3 -m mapping_tpu_torch.main` that
reports its own peak RSS (ru_maxrss) at exit, writing
`rehearsal_results.json` under --root and printing a per-leg table. Every
leg reads the tiles through the port's JPEG decoder (its pixel stage on
the card for `--device cuda`).

Usage (on a machine with a card; `--device cpu` runs on the host):

    python3 -m mapping_tpu_torch.tools.scale_rehearsal --root build/rehearsal \\
        --n-train 5000 --n-val 1000
"""

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# runs mapping_tpu_torch.main with argv, printing the child's own peak RSS
# on stderr at exit (RUSAGE_CHILDREN maxrss is a maximum over all legs, so
# each leg reports its own)
_WRAPPER = (
    "import atexit, resource, runpy, sys\n"
    "atexit.register(lambda: sys.stderr.write(\n"
    "    '\\nPEAK_RSS_KB %d\\n'\n"
    "    % resource.getrusage(resource.RUSAGE_SELF).ru_maxrss))\n"
    "sys.argv = ['mapping_tpu_torch.main'] + {argv!r}\n"
    "runpy.run_module('mapping_tpu_torch.main', run_name='__main__')\n"
)


def make_image(rng, h=300, w=300, max_buildings=6):
    """tests/fixtures/synthetic.py `_make_image`: a textured background
    and axis-aligned bright "buildings" with COCO polygon annotations
    (category 100); the same draws from `rng`."""
    img = rng.randint(30, 90, (h, w, 3)).astype(np.uint8)
    noise = rng.randint(0, 25, (h, w, 3))
    img = np.clip(img + noise, 0, 255).astype(np.uint8)
    anns = []
    n = rng.randint(1, max_buildings + 1)
    occupied = np.zeros((h, w), bool)
    for _ in range(n):
        bw = rng.randint(20, 80)
        bh = rng.randint(20, 80)
        x0 = rng.randint(5, w - bw - 5)
        y0 = rng.randint(5, h - bh - 5)
        if occupied[y0:y0 + bh, x0:x0 + bw].any():
            continue
        occupied[y0:y0 + bh, x0:x0 + bw] = True
        color = rng.randint(170, 255, (3,))
        img[y0:y0 + bh, x0:x0 + bw] = color
        img[y0:y0 + 2, x0:x0 + bw] = np.clip(color - 40, 0, 255)
        poly = [float(x0), float(y0), float(x0 + bw), float(y0),
                float(x0 + bw), float(y0 + bh), float(x0), float(y0 + bh)]
        anns.append({
            "segmentation": [poly],
            "area": float(bw * bh),
            "bbox": [float(x0), float(y0), float(bw), float(bh)],
            "iscrowd": 0,
            "category_id": 100,
        })
    return img, anns


def _write_jpeg(path, img):
    from mapping_tpu_torch.utils import jpeg

    with open(path, "wb") as f:
        f.write(jpeg.encode(img, quality=95, sampling="4:2:0"))


def generate_split(out_dir, split, n_images, seed, tile=(300, 300),
                   max_buildings=6, workers=8):
    """tests/fixtures/synthetic.py `generate_split`, the tiles encoded on
    `workers` threads while the next ones are drawn."""
    rng = np.random.RandomState(seed)
    images_dir = os.path.join(out_dir, split, "images")
    os.makedirs(images_dir, exist_ok=True)
    dataset = {
        "info": {"description": f"synthetic mapping fixture ({split})"},
        "images": [],
        "annotations": [],
        "categories": [{"id": 100, "name": "building",
                        "supercategory": "building"}],
    }
    ann_id = 1
    with ThreadPoolExecutor(max_workers=workers) as pool:
        writes = []
        for i in range(n_images):
            img, anns = make_image(rng, h=tile[0], w=tile[1],
                                   max_buildings=max_buildings)
            file_name = f"{split}_{i:05d}.jpg"
            writes.append(pool.submit(
                _write_jpeg, os.path.join(images_dir, file_name), img))
            image_id = i + 1
            dataset["images"].append({
                "id": image_id, "file_name": file_name,
                "height": img.shape[0], "width": img.shape[1],
            })
            for ann in anns:
                ann = dict(ann)
                ann["id"] = ann_id
                ann["image_id"] = image_id
                ann_id += 1
                dataset["annotations"].append(ann)
            if len(writes) > 4 * workers:
                writes.pop(0).result()
        for w in writes:
            w.result()
    ann_path = os.path.join(out_dir, split, "annotation.json")
    with open(ann_path, "w") as f:
        json.dump(dataset, f)
    # the reference's dev-mode mask prep reads annotation-small.json
    with open(os.path.join(out_dir, split, "annotation-small.json"),
              "w") as f:
        json.dump(dataset, f)
    return ann_path


def generate(out_dir, n_train=12, n_val=6, seed=7, tile=(300, 300),
             max_buildings=6):
    """tests/fixtures/synthetic.py `generate`."""
    os.makedirs(out_dir, exist_ok=True)
    generate_split(out_dir, "train", n_train, seed, tile=tile,
                   max_buildings=max_buildings)
    generate_split(out_dir, "val", n_val, seed + 1, tile=tile,
                   max_buildings=max_buildings)
    return out_dir


def write_config(path, params):
    """The `parameters:` yaml layout that the port's reader takes
    (config.parse_yaml: scalars and flow lists; the JAX rehearsal's JSON
    file is a flow mapping, which it refuses)."""
    with open(path, "w") as f:
        f.write("parameters:\n")
        for key, value in params.items():
            f.write(f"  {key}: {json.dumps(value)}\n")


def run_leg(name, argv, config_path, results, log_dir):
    env = dict(os.environ)
    env["CONFIG_PATH"] = config_path
    log_path = os.path.join(log_dir, f"{name}.log")
    print(f"--- {name}: mapping_tpu_torch.main {' '.join(argv)}", flush=True)
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        proc = subprocess.run(
            [sys.executable, "-c", _WRAPPER.format(argv=argv)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    wall = time.monotonic() - t0
    peak_kb = None
    with open(log_path) as f:
        for line in f:
            if line.startswith("PEAK_RSS_KB"):
                peak_kb = int(line.split()[1])
    entry = {
        "leg": name,
        "argv": argv,
        "wall_s": round(wall, 1),
        "peak_rss_mb": round(peak_kb / 1024.0, 1) if peak_kb else None,
        "returncode": proc.returncode,
        "log": log_path,
    }
    results.append(entry)
    print(f"    {wall:8.1f}s  peak {entry['peak_rss_mb']} MB  "
          f"rc={proc.returncode}", flush=True)
    if proc.returncode != 0:
        print(f"    FAILED — tail of {log_path}:", flush=True)
        with open(log_path) as f:
            print("".join(f.readlines()[-20:]), flush=True)
    return proc.returncode == 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--n-train", type=int, default=5000)
    ap.add_argument("--n-val", type=int, default=1000)
    ap.add_argument("--max-buildings", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--scoring-examples", type=int, default=2000)
    ap.add_argument("--encoder", default="ResNet34")
    ap.add_argument("--device", default="cuda",
                    help="the pipelines' device (the config's `device`)")
    ap.add_argument("--skip-generate", action="store_true")
    ap.add_argument("--legs", default="",
                    help="comma-separated subset of leg names to run")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    data_dir = os.path.join(root, "data")
    os.makedirs(root, exist_ok=True)
    log_dir = os.path.join(root, "logs")
    os.makedirs(log_dir, exist_ok=True)

    if not args.skip_generate:
        print(f"generating {args.n_train} train / {args.n_val} val tiles "
              f"(max {args.max_buildings} buildings/tile)...", flush=True)
        t0 = time.monotonic()
        generate(data_dir, n_train=args.n_train, n_val=args.n_val, seed=7,
                 max_buildings=args.max_buildings)
        ann = os.path.getsize(os.path.join(data_dir, "train",
                                           "annotation.json"))
        print(f"generated in {time.monotonic() - t0:.0f}s; train "
              f"annotation.json = {ann / 1e6:.1f} MB", flush=True)

    params = {
        "data_dir": data_dir,
        "meta_dir": os.path.join(root, "meta"),
        "experiment_dir": os.path.join(root, "experiment"),
        "encoder": args.encoder,
        # production defaults where it matters for memory/throughput:
        # 256px inputs, batch 20, per-epoch COCO-AP validation on the
        # standard 1000-image sample
        "image_h": 256,
        "image_w": 256,
        "batch_size_train": 20,
        "batch_size_inference": 20,
        "epochs_nr": args.epochs,
        "patience": 100,
        "validate_with_map": 1,
        "evaluation_data_sample": 1000,
        "scoring_model__num_training_examples": args.scoring_examples,
        "lgbm__number_of_trees": 100,
        "device": args.device,
    }
    config_path = os.path.join(root, "config.yaml")
    write_config(config_path, params)
    config19_path = os.path.join(root, "config19.yaml")
    write_config(config19_path, dict(params, category_layers=[1, 19]))

    artifact_dir = os.path.join(root, "artifact")
    legs = [
        ("prepare_masks", ["prepare_masks"], config_path),
        ("prepare_metadata", ["prepare_metadata"], config_path),
        ("train", ["train", "-p", "unet_weighted"], config_path),
        ("evaluate_chunked", ["evaluate", "-p", "unet", "-c", "1000"],
         config_path),
        ("evaluate_default", ["evaluate", "-p", "unet"], config_path),
        ("scoring_train", ["train", "-p", "scoring_model"], config19_path),
        ("scoring_evaluate", ["evaluate", "-p", "unet_scoring_model"],
         config19_path),
        ("export", ["export", "-p", "unet", "--dir_path", artifact_dir],
         config_path),
        ("evaluate_artifact", ["evaluate", "--artifact", artifact_dir],
         config_path),
    ]
    only = {s.strip() for s in args.legs.split(",") if s.strip()}
    results = []
    results_path = os.path.join(root, "rehearsal_results.json")
    for name, leg_argv, cfg in legs:
        if only and name not in only:
            continue
        ok = run_leg(name, leg_argv, cfg, results, log_dir)
        with open(results_path, "w") as f:
            json.dump(results, f, indent=1)
        if not ok:
            print("leg failed; stopping the ladder", flush=True)
            break

    print("\n=== rehearsal summary ===")
    print(f"{'leg':<20}{'wall_s':>10}{'peak_rss_mb':>14}  rc")
    for r in results:
        print(f"{r['leg']:<20}{r['wall_s']:>10}{str(r['peak_rss_mb']):>14}"
              f"  {r['returncode']}")
    print(f"results -> {results_path}")
    return results


if __name__ == "__main__":
    main()
