"""Command line of the PyTorch + CUDA port (torch twin of
``meatmodeler_tpu/cli.py``): ``meatmodeler-torch VIDEO -o OUT_PREFIX`` runs
the pipeline and prints the volume estimate and per-stage metrics.

The JAX package's flags and defaults, plus ``--device {cuda,cpu}``. Video
arguments are what ``io.video.FrameSource`` reads: ``.npy`` frame stacks
and ``.y4m`` files (other containers need cv2, which this package does not
use). Without a known board, boards are found by the device detector only:
a configuration that would detect with cv2 is a usage error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="meatmodeler-torch",
        description="PyTorch + CUDA SfM: turntable video -> point cloud + volume",
    )
    parser.add_argument("video", nargs="*", help="video file(s): .npy frame stack or .y4m; several videos reconstruct as a batch")
    parser.add_argument("-o", "--output", default="out", help="output prefix (writes <prefix>Cloud.ply; batches append _0, _1, ...)")
    parser.add_argument("--schedule", choices=("mesh", "pipelined", "sequential"), default="mesh", help="multi-video schedule: every BA solved as one batch (split over the GPUs where there are several), ingest and solve on two threads, or one at a time")
    parser.add_argument("--pattern", type=int, nargs=2, default=None, metavar=("W", "H"), help="chessboard inner corners")
    parser.add_argument("--side-length", type=float, default=None, help="board square size (world units)")
    parser.add_argument("--max-features", type=int, default=None, help="ORB feature budget per keyframe")
    parser.add_argument("--max-tracks", type=int, default=None, help="track-store capacity")
    parser.add_argument("--max-keyframes", type=int, default=None, help="keyframe capacity")
    parser.add_argument("--keyframe-threshold", type=float, default=None, help="keyframe accumulation threshold (reference default 0.1; smaller = denser)")
    parser.add_argument("--incremental", action="store_true", help="online BA after every keyframe (the reference's intended design)")
    parser.add_argument("--detector", choices=("auto", "device", "host"), default=None, help="chessboard detector; only 'device' runs in this package ('auto' and 'host' detect with cv2)")
    parser.add_argument("--pass1-backend", choices=("device", "host"), default=None, help="keyframe-selection backend: the device scan, or the native C++ host scan (which hunts the first board with cv2)")
    parser.add_argument("--pass1-downscale", type=int, default=None, help="pass-1 working-resolution divisor (0 = auto)")
    parser.add_argument("--pass2-downscale", type=int, default=None, help="keyframe (pass-2) resolution divisor; image-plane outputs land in the downscaled pixel units (0 = auto)")
    parser.add_argument("--checkpoint-dir", default=None, help="persist per-stage artifacts; re-runs resume")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="where the pipeline runs (cuda raises without a card)")
    parser.add_argument("--json", action="store_true", help="print metrics as JSON")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument(
        "--warmup", type=int, nargs=2, default=None, metavar=("W", "H"),
        help="build the CUDA kernels and run the pipeline once on a rendered WxH clip with known "
        "corners, then exit; pass the usual config flags to run a non-default configuration. "
        "VIDEO args are ignored.",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING, format="%(message)s")

    from meatmodeler_tpu_torch.config import DEFAULT_CONFIG
    from meatmodeler_tpu_torch.pipeline import _check_supported, process

    config = DEFAULT_CONFIG
    cb = config.chessboard
    if args.pattern is not None:
        cb = dataclasses.replace(cb, pattern=tuple(args.pattern))
    if args.side_length is not None:
        cb = dataclasses.replace(cb, side_length=args.side_length)
    if args.detector:
        cb = dataclasses.replace(cb, detector=args.detector)
    config = dataclasses.replace(config, chessboard=cb)
    if args.max_features is not None:
        config = dataclasses.replace(config, orb=dataclasses.replace(config.orb, num_features=args.max_features))
    if args.keyframe_threshold is not None:
        config = dataclasses.replace(config, keyframe=dataclasses.replace(config.keyframe, threshold=args.keyframe_threshold))
    if args.max_tracks is not None:
        config = dataclasses.replace(config, tracks=dataclasses.replace(config.tracks, max_tracks=args.max_tracks))
    if args.max_keyframes is not None:
        config = dataclasses.replace(config, tracks=dataclasses.replace(config.tracks, max_keyframes=args.max_keyframes))
    if args.incremental:
        config = dataclasses.replace(config, incremental_ba=True)
        if len(args.video) > 1 and args.schedule != "sequential":
            print(
                "note: --incremental requires the sequential schedule for multi-video input; "
                "switching to --schedule sequential",
                file=sys.stderr,
            )
            args.schedule = "sequential"
    if args.pass1_backend is not None:
        config = dataclasses.replace(config, pass1_backend=args.pass1_backend)
    if args.pass1_downscale is not None:
        config = dataclasses.replace(config, pass1_downscale=args.pass1_downscale)
    if args.pass2_downscale is not None:
        config = dataclasses.replace(config, pass2_downscale=args.pass2_downscale)

    if args.warmup is not None:
        return _warmup(tuple(args.warmup), config, args.device)
    if not args.video:
        parser.error("video is required (or pass --warmup W H)")
    try:
        # The command line gives no known corners, so every video finds its
        # board on its own.
        _check_supported(config, None)
    except NotImplementedError as e:
        flags = [f for f, needed in (("--detector device", cb.detector != "device"),
                                     ("--pass1-backend device", config.pass1_backend == "host")) if needed]
        parser.error(f"{e} (on the command line: {' '.join(flags)})")

    if len(args.video) == 1:
        results = [
            process(args.video[0], path=args.output, config=config, checkpoint_dir=args.checkpoint_dir, device=args.device)
        ]
    else:
        paths = [f"{args.output}_{i}" for i in range(len(args.video))]
        if args.checkpoint_dir and args.schedule != "sequential":
            print(
                "note: --checkpoint-dir requires the sequential schedule for multi-video input; "
                "switching to --schedule sequential",
                file=sys.stderr,
            )
            args.schedule = "sequential"
        if args.schedule == "pipelined":
            from meatmodeler_tpu_torch.parallel.pipelined import process_batch_pipelined

            devices = None if args.device == "cuda" else (args.device, args.device)
            results = process_batch_pipelined(args.video, config=config, devices=devices, paths=paths)
        elif args.schedule == "mesh":
            from meatmodeler_tpu_torch.parallel.batch import process_batch

            results = process_batch(
                args.video, config=config, paths=paths, device=args.device, mesh=_batch_mesh(args.device, len(args.video))
            )
        else:
            results = [
                process(
                    v, path=p, config=config, device=args.device,
                    checkpoint_dir=f"{args.checkpoint_dir}_{i}" if args.checkpoint_dir else None,
                )
                for i, (v, p) in enumerate(zip(args.video, paths))
            ]
    if args.json:
        payloads = [
            {
                "video": v,
                "points": int(len(r.points)),
                "keyframes": int(len(r.extrinsics)),
                "volume": r.volume,
                "volume_carved": r.volume_carved,
                "reprojection_rmse": r.reprojection_rmse,
                "ply": r.ply_path,
                **r.metrics,
            }
            for v, r in zip(args.video, results)
        ]
        print(json.dumps(payloads[0] if len(payloads) == 1 else payloads))
    else:
        for v, result in zip(args.video, results):
            if len(results) > 1:
                print(f"--- {v}")
            print(f"keyframes:          {len(result.extrinsics)}")
            print(f"points:             {len(result.points)}")
            print(f"reprojection RMSE:  {result.reprojection_rmse:.3f} px")
            print(f"volume (hull):      {result.volume:.3f}")
            print(f"volume (carved):    {result.volume_carved:.3f}")
            if result.ply_path:
                print(f"cloud written to:   {result.ply_path}")
    return 0


def _batch_mesh(device: str, n_videos: int):
    """The mesh a ``--schedule mesh`` batch solves on: its data axis sized
    to the batch (a mesh over every GPU would pad the batch up to the GPU
    count with redundant solves); None on one GPU and on the CPU."""
    if device != "cuda":
        return None
    import torch

    from meatmodeler_tpu_torch.parallel import sharded

    data = min(torch.cuda.device_count(), n_videos)
    return sharded.make_mesh(data=data, model=1) if data > 1 else None


def _warmup(size, config, device) -> int:
    """``meatmodeler-torch --warmup W H``: build the CUDA kernels (the one
    artefact that persists from one process to the next) and run the
    pipeline once, with the exact config the user will run, on a short
    rendered WxH clip with its known corners."""
    import time

    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu_torch.pipeline import process

    w, h = size
    t0 = time.time()
    if device == "cuda":
        from meatmodeler_tpu_torch.ops import clahe_cuda, klt_cuda

        clahe_cuda.build()
        klt_cuda.build()
        print(f"warmup: kernels built ({time.time() - t0:.1f}s)", file=sys.stderr)
    scene = TurntableScene(
        image_size=(w, h), focal=0.78 * max(w, h), noise_sigma=1.0,
        pattern=config.chessboard.pattern, side_length=config.chessboard.side_length,
    )
    n_frames = 3 * config.frame_chunk
    frames, _, corners = render_sequence(scene, n_frames, seed=0)
    print(f"warmup: rendered {n_frames} frames at {w}x{h} ({time.time() - t0:.1f}s); running the pipeline...",
          file=sys.stderr)
    try:
        process(frames, config=config, known_corners=corners, device=device)
    except ValueError as e:
        # Too few keyframes on the short clip: the stages up to there ran.
        print(f"warmup: partial ({e})", file=sys.stderr)
    print(f"warmup: done in {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
