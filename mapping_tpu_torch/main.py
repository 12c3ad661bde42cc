"""CLI of the port: the JAX package's command surface.

    python3 -m mapping_tpu_torch.main [--config FILE] COMMAND [options]

Counterpart of mapping_tpu/main.py with argparse in place of click: the
same command names, flags and --config (default $CONFIG_PATH). Commands:
prepare_masks, prepare_metadata, train, train_evaluate, evaluate
(`--artifact DIR` scores an exported artifact), predict_on_dir (also
`--artifact DIR`), import_checkpoint, serve (the HTTP daemon,
infer/daemon.py, over a pipeline or `--artifact DIR`) and export (the
serve program per batch bucket with torch.export, infer/artifact.py; prints
the manifest). The parameter `device` (default cuda) says where the model,
the target preparation and an artifact run; a CUDA device needs a card.
The other commands of the JAX CLI exit non-zero, naming the ROADMAP item
that ports them.

    python3 -m mapping_tpu_torch.main --config config.yaml train -p unet_weighted
    python3 -m mapping_tpu_torch.main --config config.yaml evaluate -p unet_tta
    python3 -m mapping_tpu_torch.main --config config.yaml export \
        -p unet_weighted --dir_path artifact
    python3 -m mapping_tpu_torch.main --config config.yaml evaluate \
        --artifact artifact
    python3 -m mapping_tpu_torch.main --config config.yaml serve \
        --artifact artifact --port 8000
    # with `category_layers: [1, 19]` in scoring.yaml:
    python3 -m mapping_tpu_torch.main --config scoring.yaml train -p scoring_model
    python3 -m mapping_tpu_torch.main --config scoring.yaml evaluate \
        -p unet_tta_scoring_model
"""

import argparse
import json
import logging
import sys

from mapping_tpu_torch.manager import PipelineManager

#: commands of the JAX CLI not ported yet -> ROADMAP item
NOT_PORTED = {"visualize": "23", "parity_drill": "23"}
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

    for name in NOT_PORTED:
        p = sub.add_parser(name, help="not ported")
        p.add_argument("rest", nargs=argparse.REMAINDER)
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
    args = _parser().parse_args(argv)
    if args.command in NOT_PORTED:
        raise SystemExit(f"{args.command} is not ported to PyTorch yet "
                         f"(ROADMAP item {NOT_PORTED[args.command]})")
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
