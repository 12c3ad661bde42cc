"""CLI of the port: the JAX package's command surface.

    python3 -m mapping_tpu_torch.main [--config FILE] COMMAND [options]

Counterpart of mapping_tpu/main.py with argparse in place of click: the
same command names, flags and --config (default $CONFIG_PATH). Commands:
prepare_masks, prepare_metadata, train, train_evaluate, evaluate
(`--artifact DIR` scores an exported artifact), predict_on_dir (also
`--artifact DIR`), import_checkpoint, serve (the HTTP daemon,
infer/daemon.py, over a pipeline or `--artifact DIR`), export (the
serve program per batch bucket with torch.export, infer/artifact.py; prints
the manifest), visualize (ground-truth-vs-prediction overlay PNGs of a
prediction.json, utils/visualize.py; prints {"written": [...]}; needs no
card) and parity_drill (import a reference checkpoint, evaluate, print
the report against the reference's AP 0.943 / AR 0.954; `--checkpoint`
defaults to $CHECKPOINT, `--data_dir` to $DATA_DIR, then the config's).
The parameter `device` (default cuda) says where the model, the target
preparation and an artifact run; a CUDA device needs a card.

    python3 -m mapping_tpu_torch.main --config config.yaml train -p unet_weighted
    python3 -m mapping_tpu_torch.main --config config.yaml evaluate -p unet_tta
    python3 -m mapping_tpu_torch.main --config config.yaml export \
        -p unet_weighted --dir_path artifact
    python3 -m mapping_tpu_torch.main --config config.yaml evaluate \
        --artifact artifact
    python3 -m mapping_tpu_torch.main --config config.yaml serve \
        --artifact artifact --port 8000
    python3 -m mapping_tpu_torch.main --config config.yaml visualize \
        --prediction_path experiment/prediction.json --out_dir overlays
    DATA_DIR=... CHECKPOINT=ref.pth python3 -m mapping_tpu_torch.main \
        --config config.yaml parity_drill
    # with `category_layers: [1, 19]` in scoring.yaml:
    python3 -m mapping_tpu_torch.main --config scoring.yaml train -p scoring_model
    python3 -m mapping_tpu_torch.main --config scoring.yaml evaluate \
        -p unet_tta_scoring_model
"""

import argparse
import json
import logging
import os
import sys

from mapping_tpu_torch.manager import PipelineManager, parity_drill
from mapping_tpu_torch.utils.visualize import visualize_predictions

_WARM_START_HELP = ("continue training from the cached transformer under the "
                    "current yaml (stage 2+ of the multistage recipe); the "
                    "completed previous stage is archived, not overwritten")


def _parser():
    ap = argparse.ArgumentParser(prog="python3 -m mapping_tpu_torch.main",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", dest="config_path", default=None,
                    help="yaml parameter file (defaults to $CONFIG_PATH)")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("prepare_masks")
    p.add_argument("-d", "--dev_mode", action="store_true")

    p = sub.add_parser("prepare_metadata")
    p.add_argument("-tr", "--train_data", action="store_true")
    p.add_argument("-val", "--valid_data", action="store_true")

    p = sub.add_parser("train")
    p.add_argument("-p", "--pipeline_name", default="unet_weighted")
    p.add_argument("-d", "--dev_mode", action="store_true")
    p.add_argument("-w", "--warm_start", action="store_true",
                   help=_WARM_START_HELP)

    p = sub.add_parser("train_evaluate")
    p.add_argument("-p", "--pipeline_name", default="unet_weighted")
    p.add_argument("-d", "--dev_mode", action="store_true")
    p.add_argument("-c", "--chunk_size", type=int, default=None)
    p.add_argument("-w", "--warm_start", action="store_true",
                   help=_WARM_START_HELP)

    p = sub.add_parser("evaluate")
    p.add_argument("-p", "--pipeline_name", default="unet")
    p.add_argument("-d", "--dev_mode", action="store_true")
    p.add_argument("-c", "--chunk_size", type=int, default=None)
    p.add_argument("--artifact", dest="artifact_dir", default=None,
                   help="score an exported serving artifact on the "
                        "validation sample (no checkpoint or model code)")

    p = sub.add_parser("predict_on_dir")
    p.add_argument("-p", "--pipeline_name", default="unet")
    p.add_argument("--dir_path", required=True)
    p.add_argument("--prediction_path", required=True)
    p.add_argument("-c", "--chunk_size", type=int, default=None)
    p.add_argument("--artifact", dest="artifact_dir", default=None,
                   help="predict with an exported serving artifact instead "
                        "of a pipeline")

    p = sub.add_parser("import_checkpoint")
    p.add_argument("-p", "--pipeline_name", default="unet")
    p.add_argument("--path", dest="checkpoint_path", required=True,
                   help="complete torch UNet state_dict (plain, "
                        "{'state_dict': ...}-wrapped or 'module.'-prefixed)")

    p = sub.add_parser("serve")
    p.add_argument("-p", "--pipeline_name", default="unet")
    p.add_argument("--artifact", dest="artifact_dir", default=None,
                   help="serve an exported artifact instead of a pipeline")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="microbatch coalescing window after the first "
                        "request")
    p.add_argument("--max_pending", type=int, default=None,
                   help="queued-request cap before 429 load-shedding "
                        "(default 8x batch; a pipeline also honours "
                        "serve_max_pending)")

    p = sub.add_parser("export")
    p.add_argument("-p", "--pipeline_name", default="unet")
    p.add_argument("--dir_path", required=True,
                   help="output directory of the serving artifact")
    p.add_argument("--platforms", default=None,
                   help="the device class to export for (cpu or cuda); it "
                        "must be the config's device")

    p = sub.add_parser("visualize")
    p.add_argument("--prediction_path", required=True,
                   help="a COCO results json (what evaluate/predict_on_dir "
                        "write)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("-n", "--n_images", type=int, default=8)
    p.add_argument("--dataset", default="val",
                   help="GT split under data_dir (annotation.json + "
                        "images/)")
    p.add_argument("--score_threshold", type=float, default=0.0)
    p.add_argument("--max_dets", type=int, default=100,
                   help="draw at most the top-K detections per image by "
                        "score; 0 = unlimited")
    p.add_argument("--hide_suppressed", dest="hide_suppressed",
                   action="store_true", default=True,
                   help="hide score 0 instances (NMS-suppressed markers of "
                        "a scoring pipeline's emit_suppressed output)")
    p.add_argument("--show_suppressed", dest="hide_suppressed",
                   action="store_false")

    p = sub.add_parser("parity_drill")
    p.add_argument("-p", "--pipeline_name", default="unet")
    p.add_argument("--checkpoint", dest="checkpoint_path",
                   default=os.environ.get("CHECKPOINT"),
                   help="reference trained checkpoint (torch state_dict); "
                        "defaults to $CHECKPOINT")
    p.add_argument("--data_dir", default=os.environ.get("DATA_DIR"),
                   help="CrowdAI dataset root (train/ + val/ with "
                        "annotation.json); defaults to $DATA_DIR, else the "
                        "config's data_dir")
    p.add_argument("-c", "--chunk_size", type=int, default=None)
    p.add_argument("-d", "--dev_mode", action="store_true")
    return ap


def _init_logger():
    logger = logging.getLogger("mapping_tpu_torch")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s >>> %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False


def main(argv=None) -> PipelineManager:
    """Run one command; returns the PipelineManager that ran it."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.command == "parity_drill" and not args.checkpoint_path:
        ap.error("no checkpoint: pass --checkpoint or set $CHECKPOINT")
    _init_logger()
    manager = PipelineManager(args.config_path)
    if args.command == "prepare_masks":
        manager.prepare_masks(args.dev_mode)
        return manager
    if args.command == "prepare_metadata":
        train_data, valid_data = args.train_data, args.valid_data
        if not (train_data or valid_data):
            train_data = valid_data = True
        manager.prepare_metadata(train_data, valid_data)
        return manager
    if args.command == "serve":
        _serve(manager, args)
        return manager
    if args.command == "export":
        _export(manager, args)
        return manager
    if args.command == "visualize":
        written = visualize_predictions(
            args.prediction_path, manager.params.data_dir, args.out_dir,
            dataset=args.dataset, n_images=args.n_images,
            score_threshold=args.score_threshold, max_dets=args.max_dets,
            hide_suppressed=args.hide_suppressed)
        print(json.dumps({"written": written}))
        return manager
    if args.command == "parity_drill":
        report = parity_drill(manager, args.pipeline_name,
                              args.checkpoint_path, data_dir=args.data_dir,
                              chunk_size=args.chunk_size,
                              dev_mode=args.dev_mode)
        print(json.dumps(report, indent=1))
        return manager
    device = manager.params.get("device", "cuda")
    if args.command == "predict_on_dir" and args.artifact_dir:
        from mapping_tpu_torch.infer.artifact import predict_dir_with_artifact

        manager.timings = {}
        predict_dir_with_artifact(
            args.artifact_dir, args.dir_path, args.prediction_path,
            chunk_images=args.chunk_size or 0,
            data_parallel=bool(manager.params.get("data_parallel", 0)),
            device=device, timings=manager.timings)
        return manager
    manager.start_experiment()
    if args.command in ("train", "train_evaluate"):
        manager.train(args.pipeline_name, args.dev_mode,
                      warm_start=args.warm_start)
    if args.command == "evaluate" and args.artifact_dir:
        manager.evaluate_artifact(args.artifact_dir, args.dev_mode,
                                  args.chunk_size)
    elif args.command in ("evaluate", "train_evaluate"):
        manager.evaluate(args.pipeline_name, args.dev_mode, args.chunk_size)
    elif args.command == "predict_on_dir":
        manager.predict_on_dir(args.pipeline_name, args.dir_path,
                               args.prediction_path, args.chunk_size)
    elif args.command == "import_checkpoint":
        manager.import_checkpoint(args.checkpoint_path, args.pipeline_name)
    manager.finish_experiment()
    return manager


def _serve(manager, args):
    """Online serving until the process is stopped."""
    from mapping_tpu_torch.infer.daemon import (daemon_from_artifact,
                                                daemon_from_pipeline)
    from mapping_tpu_torch.pipelines import PIPELINES

    if args.artifact_dir:
        daemon = daemon_from_artifact(
            args.artifact_dir, host=args.host, port=args.port,
            max_wait_ms=args.max_wait_ms, max_pending=args.max_pending,
            device=manager.params.get("device", "cuda"))
    else:
        pipeline = PIPELINES[args.pipeline_name]["inference"](manager.config)
        daemon = daemon_from_pipeline(
            pipeline, manager.config, host=args.host, port=args.port,
            max_wait_ms=args.max_wait_ms, max_pending=args.max_pending)
    daemon.serve_forever()


def _export(manager, args):
    from mapping_tpu_torch.infer.artifact import export_serving_artifact
    from mapping_tpu_torch.pipelines import PIPELINES

    pipeline = PIPELINES[args.pipeline_name]["inference"](manager.config)
    platforms = ([p.strip() for p in args.platforms.split(",") if p.strip()]
                 if args.platforms else None)
    manifest = export_serving_artifact(pipeline, manager.config,
                                       args.dir_path, platforms=platforms)
    print(json.dumps(manifest, indent=1))


if __name__ == "__main__":
    main()
