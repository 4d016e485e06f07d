"""Multi-scene validation harness for the hull volume estimator (torch
package's twin of ``tools/volume_validation.py``).

The hull estimator's robustness knobs (support-cloud gating, the
order-statistic trim and its sparse-aware scaling, support inflation)
interact with scene scale and texture in ways single-scene tuning gets
wrong. This harness renders a SPREAD of synthetic turntable scenes (sizes,
ellipsoid shapes, arcs, noise), runs the real pipeline on each, captures
the volume stage's exact inputs (cloud, per-point sigma and parallax, K,
extrinsics), and tabulates estimator variants against each scene's
analytic truth: the decision record for the shipped volume configuration
(``config.VolumeConfig``: gated support, trim 5, trim_ref 1500, inflate 0).

Pipeline runs go to ``--device`` (``cuda`` by default; without CUDA the
harness refuses and never moves to the CPU on its own). Captures are
cached as ``<cache>/volval_torch_<name>.npz`` (``--cache``, by default the
repo's ``.cache``; delete one to re-render) with the JAX harness's keys,
so either package's capture evaluates in both; external captures
(``<cache>/volval_ext_*.npz``, the same keys) are picked up as well.

Usage:  python3 -m meatmodeler_tpu_torch.tools.volume_validation [--scenes a,b,...]
            [--trims 1,2,3,5,7] [--trim-refs 0] [--inflates 0] [--device cuda] [--cache DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from meatmodeler_tpu_torch import pipeline, volume
from meatmodeler_tpu_torch.config import DEFAULT_CONFIG, VolumeConfig
from meatmodeler_tpu_torch.geometry import projection
from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence

REPO = Path(__file__).resolve().parents[2]
CACHE = REPO / ".cache"


def validation_scenes() -> Dict[str, Tuple[TurntableScene, int, object]]:
    """Name -> (scene, n_frames, config). Spans image scale, ellipsoid shape,
    arc width and noise: the axes the estimator's knobs are sensitive to.
    The JAX harness's four scenes and config changes on this package's
    ``DEFAULT_CONFIG``, with one more: ``chessboard.detector="device"``.
    The default ``"auto"`` falls back to cv2 for each frame the device
    detector misses, and this package does not use cv2 (``process``
    refuses it without known corners)."""
    base = dataclasses.replace(
        DEFAULT_CONFIG,
        keyframe=dataclasses.replace(DEFAULT_CONFIG.keyframe, threshold=0.04),
        tracks=dataclasses.replace(DEFAULT_CONFIG.tracks, max_keyframes=48, triangulation="nview"),
        chessboard=dataclasses.replace(DEFAULT_CONFIG.chessboard, detector="device"),
    )
    s = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=1.0)
    return {
        # the e2e test scene
        "e2e_400": (s, 40, base),
        # flat and elongated ellipsoids (support anisotropy)
        "flat_400": (dataclasses.replace(s, ellipsoid_axes=(2.4, 0.9, 1.6)), 40, base),
        "long_480": (
            dataclasses.replace(s, image_size=(480, 360), focal=520.0, ellipsoid_axes=(3.0, 1.2, 1.2)), 40, base,
        ),
        # wider arc + more views (better-conditioned carve)
        "wide_640": (
            dataclasses.replace(s, image_size=(640, 480), focal=700.0, arc_degrees=80.0, noise_sigma=1.5), 48, base,
        ),
    }


def capture_scene(name, scene, n_frames, config, device="cuda", cache: Path = CACHE) -> Dict[str, np.ndarray]:
    """Run ``process`` once on ``device``, hooking the volume stage's
    inputs; cached in ``cache``. Besides the JAX harness's keys the capture
    holds ``device`` and the run's own hull and carved volume
    (``run_hull``, ``run_carve``)."""
    path = Path(cache) / f"volval_torch_{name}.npz"
    if path.exists():
        return dict(np.load(path))
    frames, _, _ = render_sequence(scene, n_frames, seed=0)
    orig = pipeline._estimate_volume
    cap = {}

    def hook(pts, intrinsics, ext4, image_size, cfg, point_sigma, point_parallax, kf_scale, use_plane=True):
        out = orig(pts, intrinsics, ext4, image_size, cfg, point_sigma, point_parallax, kf_scale, use_plane=use_plane)
        cap.update(
            pts=pts.cpu().numpy(), intr=intrinsics.cpu().numpy(), ext4=ext4.cpu().numpy(), n_kf=int(ext4.shape[0]),
            image_size=np.asarray(image_size), sigma=point_sigma.cpu().numpy(),
            parallax=point_parallax.cpu().numpy(), kf_scale=kf_scale,
            run_hull=float(out[0]), run_carve=float(out[1]),
        )
        return out

    pipeline._estimate_volume = hook
    try:
        pipeline.process(frames, config=config, device=device)
    finally:
        pipeline._estimate_volume = orig
    cap["truth"] = scene.volume
    cap["device"] = np.asarray(str(device))
    # The scene's own carve knobs ride along, so variants are evaluated
    # with the configuration the scene ships with.
    v = config.volume
    cap["vcfg"] = np.array([v.voxel_resolution, v.hull_directions, v.carve_dilation, v.carve_close_frac,
                            v.carve_vote_frac, v.max_point_sigma, v.min_parallax_deg], np.float64)
    Path(cache).mkdir(parents=True, exist_ok=True)
    np.savez(path, **cap)
    return cap


def _device(cap, device) -> torch.device:
    return torch.device(device if device is not None else str(cap.get("device", "cuda")))


def masks_for(cap, vcfg: VolumeConfig, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """``_estimate_volume``'s gating on a capture: (gated, ungated) item
    masks. Runs on ``device``, by default the capture's."""
    dev = _device(cap, device)
    pts = torch.from_numpy(np.asarray(cap["pts"])).to(dev)
    pmask = np.ones(pts.shape[0], bool)
    precise = cap["sigma"] <= vcfg.max_point_sigma
    if precise.sum() >= 32:
        pmask = precise
    certain = pmask & (cap["parallax"] >= vcfg.min_parallax_deg)
    if certain.sum() >= 32:
        pmask = certain
    gated = volume.split_item_points(pts, torch.from_numpy(pmask).to(dev)).cpu().numpy()
    ungated = volume.split_item_points(pts, torch.ones(pts.shape[0], dtype=torch.bool, device=dev)).cpu().numpy()
    return gated, ungated


def eval_variant(cap, vcfg: VolumeConfig, support: str, trim: int, trim_ref: int = 0, inflate: float = 0.0,
                 device=None) -> Tuple[float, float]:
    """(hull, carved volume) of one estimator variant on a capture: the
    ``gated`` or ``ungated`` support cloud, ``trim``, ``trim_ref`` and
    ``support_inflate``. Runs on ``device``, by default the capture's."""
    dev = _device(cap, device)
    pts = torch.from_numpy(np.asarray(cap["pts"])).to(dev)
    gated, ungated = masks_for(cap, vcfg, dev)
    smask = gated if support == "gated" else ungated
    kf_scale = int(cap["kf_scale"])
    proj = projection.projection_from_extrinsic(torch.from_numpy(np.asarray(cap["intr"])).to(dev),
                                                torch.from_numpy(np.asarray(cap["ext4"])).to(dev)[:, :3, :])
    hull, carve = volume.hull_and_carved_volume(
        pts, torch.from_numpy(gated).to(dev), proj, torch.ones(int(cap["n_kf"]), dtype=torch.bool, device=dev),
        image_size=tuple(int(x) for x in cap["image_size"]),
        resolution=vcfg.voxel_resolution,
        num_directions=vcfg.hull_directions, trim=trim,
        dilation=max(1, round(vcfg.carve_dilation / kf_scale)),
        grid_step=max(1, 4 // kf_scale),
        close_frac=vcfg.carve_close_frac, vote_frac=vcfg.carve_vote_frac,
        support_mask=torch.from_numpy(smask).to(dev),
        trim_ref=trim_ref,
        support_inflate=inflate,
    )
    return float(hull), float(carve)


def cfg_of(cap) -> VolumeConfig:
    """The capture's volume configuration (its ``vcfg``, else the default)."""
    if "vcfg" not in cap:
        return VolumeConfig()
    r, d, dil, cf, vf, ms, mp = [float(x) for x in cap["vcfg"]]
    return VolumeConfig(voxel_resolution=int(r), hull_directions=int(d), carve_dilation=int(dil),
                        carve_close_frac=cf, carve_vote_frac=vf, max_point_sigma=ms, min_parallax_deg=mp)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", default=None, help="comma-separated subset")
    ap.add_argument("--trims", default="1,2,3,5,7")
    # Sparse-aware trim scaling (VolumeConfig.hull_trim_ref): depth reaches
    # `trim` at `trim_ref` support points, scales linearly below. 0 = fixed.
    ap.add_argument("--trim-refs", default="0")
    # Sampling-interval support inflation (volume.hull_and_carved_volume
    # support_inflate): fraction of the support cloud's median 6th-NN
    # distance added to every support plane.
    ap.add_argument("--inflates", default="0")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache", type=Path, default=CACHE)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("volume_validation: CUDA is not available (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2

    scenes = validation_scenes()
    if args.scenes:
        scenes = {k: scenes[k] for k in args.scenes.split(",")}
    caps = {}
    for name, (scene, n, cfg) in scenes.items():
        print(f"capturing {name}...", file=sys.stderr)
        caps[name] = capture_scene(name, scene, n, cfg, args.device, args.cache)
    for ext in sorted(Path(args.cache).glob("volval_ext_*.npz")):
        caps[ext.stem.replace("volval_ext_", "ext_")] = dict(np.load(ext))

    trims = [int(t) for t in args.trims.split(",")]
    trim_refs = [int(t) for t in args.trim_refs.split(",")]
    inflates = [float(t) for t in args.inflates.split(",")]
    rows = {}
    for trim in trims:
        for tref in trim_refs:
            for inf in inflates:
                errs = {}
                for name, cap in caps.items():
                    hull, _ = eval_variant(cap, cfg_of(cap), "gated", trim, trim_ref=tref, inflate=inf,
                                           device=args.device)
                    errs[name] = hull / float(cap["truth"]) - 1.0
                worst = max(abs(e) for e in errs.values())
                rows[("gated", trim, tref, inf)] = (errs, worst)
                cells = "  ".join(f"{n}:{e:+.1%}" for n, e in errs.items())
                print(f"{'gated':8s} trim={trim:2d} ref={tref:4d} inf={inf:.2f}  worst={worst:.1%}  {cells}")
    best = min(rows.items(), key=lambda kv: kv[1][1])
    print(f"\nbest variant: support={best[0][0]} trim={best[0][1]} trim_ref={best[0][2]} inflate={best[0][3]} "
          f"worst-case |err|={best[1][1]:.1%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
