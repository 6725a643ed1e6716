"""Production inference CLI of the PyTorch port (reference predict.py:61-81
parity).

Usage: ``bark-predict-torch ROOT_DIR`` (or ``python -m
neuralbarkcalculator_tpu_torch.cli.predict ROOT_DIR``) ``[--device
{cuda,cpu}] [--exclude_nodes] [--only_preprocess] [--resume]
[--preprocess_backend {auto,device,host}] [--watch SECS] [--int8]
[--shard K/N] [--mpl]``

Runs on the card by default (``--device cuda``) and raises when there is
none; ``--device cpu`` runs the same path on the CPU. It creates the
output folders, preprocesses ROOT/samples (on the device or the host) and
predicts, streaming (preprocess overlapped with prediction) or
sequentially. ``--resume`` skips images already processed and predicted;
``--watch SECS`` rescans ROOT every SECS seconds and handles only new
images, until interrupted. ``--int8`` quantizes the model on the first
batch (models/quantize.py); an offline int8 checkpoint as
``--model_path`` runs int8 without it. ``--model_path`` takes every
checkpoint the JAX package's predict CLI takes (a reference ``.pt``, a
flax ``.msgpack``, an orbax directory, a JAX ``.int8.msgpack``) and the
port's ``.int8.pt``, with no jax, flax or orbax installed. ``--mpl`` draws the combined
figures with matplotlib Agg instead of the port's compositor, and raises
ImportError where matplotlib is not installed.

``--shard K/N`` predicts manifest indices i % N == K on this process's
card (``cuda:LOCAL_RANK``) and writes a per-shard CSV; shard 0 owns the
preprocess, the others wait for its PNGs, and shard 0 merges the N CSVs
into the final_stats.csv a single process writes (pipeline/multihost.py).
Run one process per card (N shells, or ``torchrun --nproc_per_node N``
with ``--shard $RANK/$WORLD_SIZE`` in a wrapper) or per host over a
shared filesystem: the shards never talk to each other.
"""
from __future__ import annotations

import argparse

from ..models.segmentation import MODEL_FACTORIES


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="bark calculator inference (PyTorch / CUDA)")
    parser.add_argument("root_path", type=str, help="root directory path.")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="run on the CUDA card (default; fails without "
                             "one) or on the CPU")
    parser.add_argument("--exclude_nodes", action="store_true",
                        default=False)
    parser.add_argument("--only_preprocess", action="store_true",
                        default=False)
    parser.add_argument("--model_path", type=str, default="./best_model.pt",
                        help="reference .pt, flax .msgpack, or orbax dir "
                             "(reference predict.py:57), or an offline int8 "
                             "checkpoint (the port's *.int8.pt or the JAX "
                             "package's *.int8.msgpack)")
    parser.add_argument("--model", type=str, default="fcn_resnet50",
                        choices=sorted(MODEL_FACTORIES),
                        help="model zoo entry (fcn_resnet50 is the "
                             "reference production model, models.py:221)")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="images per device step (default from "
                             "PredictConfig)")
    parser.add_argument("--dpi", type=int, default=None,
                        help="combined-figure dpi (reference hardcodes "
                             "900, models.py:346)")
    parser.add_argument("--float32", action="store_true", default=False,
                        help="run the conv stack in float32 (TF32 off) "
                             "instead of bfloat16")
    parser.add_argument("--int8", action="store_true", default=False,
                        help="int8 inference: post-training quantization "
                             "calibrated on the first batch "
                             "(models/quantize.py); approximate, ResNet "
                             "models only")
    parser.add_argument("--profile", action="store_true", default=False,
                        help="print per-stage wall-time report at the end")
    parser.add_argument("--pipeline", type=str, default="streaming",
                        choices=("streaming", "sequential"),
                        help="'streaming' (the default) feeds preprocessed "
                             "images to the predict pump as they finish; "
                             "'sequential' runs the two stages back to back")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="skip images whose processed PNG and results/ "
                             "artifacts already exist (resumable folder "
                             "runs)")
    parser.add_argument("--preprocess_backend", type=str, default="auto",
                        choices=["auto", "device", "host"],
                        help="resize and trim on the device (matrix "
                             "products) or on the host (native pass, same "
                             "math); auto measures the upload rate once "
                             "and picks")
    parser.add_argument("--watch", type=float, default=None, metavar="SECS",
                        help="rescan ROOT every SECS seconds, preprocessing "
                             "and predicting only new images (incremental "
                             "resume); Ctrl-C to stop")
    parser.add_argument("--mpl", action="store_true", default=False,
                        help="render combined figures with matplotlib Agg "
                             "(the reference's drawing) instead of the "
                             "port's compositor (same layout, faster); "
                             "needs matplotlib")
    parser.add_argument("--shard", type=str, default=None, metavar="K/N",
                        help="sharded folder prediction: this process "
                             "computes manifest indices i%%N==K and writes "
                             "a per-shard CSV; the K=0 process waits for "
                             "the others and merges final_stats.csv "
                             "(pipeline/multihost.py). Launch one process "
                             "per card or host with K=0..N-1 over a shared "
                             "filesystem")
    return parser


def parse_shard(text: str) -> tuple[int, int]:
    """``K/N`` -> (K, N); exits with a message unless 0 <= K < N."""
    try:
        k, n = (int(x) for x in text.split("/"))
    except ValueError:
        raise SystemExit(f"--shard must look like K/N, got {text!r}")
    if not 0 <= k < n:
        raise SystemExit(f"--shard {text}: need 0 <= K < N")
    return k, n


def main(args: argparse.Namespace) -> None:
    import time

    from ..config import PredictConfig
    from ..data.dataset import make_dataset
    from ..parallel.distributed import local_device
    from ..pipeline.folders import generate_folders
    from ..pipeline.multihost import (predict_folder_multihost,
                                      wait_for_processed)
    from ..pipeline.predict import NeuralBarkCalculator
    from ..pipeline.preprocess import Preprocessor
    from ..pipeline.report import require_matplotlib

    config = PredictConfig(model_path=args.model_path)
    if args.batch_size is not None:
        config.batch_size = args.batch_size
    if args.dpi is not None:
        config.figure_dpi = args.dpi
    if args.float32:
        config.use_bfloat16 = False
    if args.int8:
        config.quantize_int8 = True
    if args.mpl:
        require_matplotlib()  # before any work: no fallback
        config.renderer = "mpl"
    shard = None if args.shard is None else parse_shard(args.shard)
    device = local_device(args.device)

    model = None

    def engine() -> NeuralBarkCalculator:
        nonlocal model  # built once, reused by every watch scan
        if model is None:
            model = NeuralBarkCalculator(args.model_path, config=config,
                                         model_name=args.model,
                                         device=device)
        return model

    def run_shard(resume: bool) -> None:
        # PNG writes are not atomic, so shard 0 alone preprocesses; the
        # others wait for every processed PNG, which also gives every
        # shard the same manifest to take its indices from
        if shard[0] == 0:
            generate_folders(args.root_path, args.only_preprocess)
            Preprocessor(backend=args.preprocess_backend,
                         device=device).preprocess_images(args.root_path,
                                                          resume=True)
        else:
            wait_for_processed(args.root_path)
        if not args.only_preprocess:
            predict_folder_multihost(
                engine(), args.root_path, args.exclude_nodes,
                process_id=shard[0], num_processes=shard[1], resume=resume)

    def run_once(resume: bool) -> None:
        if shard is not None:
            run_shard(resume)
            return
        generate_folders(args.root_path, args.only_preprocess)
        pre = Preprocessor(backend=args.preprocess_backend, device=device)
        if args.only_preprocess:
            pre.preprocess_images(args.root_path, resume=resume)
        elif resume:
            # the incremental preprocess writes only new images; predict
            # then reads processed/ from disk and skips the done ones
            pre.preprocess_images(args.root_path, resume=True)
            engine().predict(args.root_path, args.exclude_nodes,
                             resume=True)
        elif args.pipeline == "streaming":
            engine().predict_streaming(
                args.root_path, pre.preprocess_stream(args.root_path),
                exclude_nodes=args.exclude_nodes,
                total=len(make_dataset(args.root_path)))
        else:
            images = pre.preprocess_images(args.root_path)
            engine().predict(args.root_path, args.exclude_nodes,
                             images=images)

    if args.watch is None:
        run_once(args.resume)
    else:
        print(f"watching {args.root_path} every {args.watch:g}s "
              f"(Ctrl-C to stop)", flush=True)
        while True:
            try:
                run_once(resume=True)
                time.sleep(args.watch)
            except KeyboardInterrupt:
                break
    if args.profile:
        from ..utils.profiling import print_report
        print_report()


def entrypoint() -> None:
    """console_scripts entry (pyproject: bark-predict-torch)."""
    main(build_parser().parse_args())


if __name__ == "__main__":
    entrypoint()
