"""A tiny cell for the harness's CPU tests: the known-corner path on a
400x300, 40-frame clip with a small-capacity configuration, in a benchmark
tree of its own beside the real one (the real files are linked in, the
tiny cell's are added)."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

from portbench import spec

TINY_SCENE = {"image_size": [400, 300], "focal": 420.0, "noise_sigma": 1.0}


def tiny_pipeline() -> dict:
    from meatmodeler_tpu_torch.config import (DEFAULT_CONFIG, KeyframeConfig, MatcherConfig, OrbConfig, TrackConfig,
                                              VolumeConfig)

    config = dataclasses.replace(
        DEFAULT_CONFIG,
        keyframe=dataclasses.replace(KeyframeConfig(), max_corners=256, threshold=0.02),
        orb=OrbConfig(num_features=768, num_levels=2),
        matcher=MatcherConfig(max_matches=512),
        tracks=TrackConfig(max_tracks=2048, max_keyframes=32),
        volume=VolumeConfig(voxel_resolution=48),
        frame_chunk=8,
        pass1_backend="host",
        pass2_enhance="grey",
    )
    return json.loads(json.dumps(dataclasses.asdict(config)))


def tiny_root(tmp: Path, checks: int = 2) -> Path:
    """A benchmark root under ``tmp`` holding the real BENCHMARK.json's
    entries and files plus two tiny cells: ``tiny_known`` (``process`` with
    the board's corners on a 400x300, 40-frame clip) and ``tiny_odometry``
    (``chain_poses`` on a 400x300, 12-frame board-free grey clip)."""
    root = Path(tmp)
    pb = root / "portbench"
    pb.mkdir(parents=True)
    for sub in ("entries", "metrics", "traffic", "configs", "checks"):
        shutil.copytree(spec.REPO / "portbench" / sub, pb / sub)
    bench = spec.load_benchmark()
    config = {"name": "tiny_board", "source": "a 400x300 test scene", "scene": TINY_SCENE, "frames": 40,
              "color": True, "pipeline": tiny_pipeline(), "assumed": [], "reduced": []}
    (pb / "configs" / "tiny_board.json").write_text(json.dumps(config))
    (pb / "traffic" / "tiny_known.json").write_text(json.dumps(
        {"entry": "process", "corners": "known", "clips": 2, "checks": checks}))
    (pb / "checks" / "tiny_known.json").write_text(json.dumps(
        {"limits": json.loads((pb / "checks" / "board_known_1080p.json").read_text())["limits"]}))
    (pb / "configs" / "tiny_markerless.json").write_text(json.dumps(dict(
        config, name="tiny_markerless", frames=12, color=False,
        scene=dict(TINY_SCENE, noise_sigma=0.5, show_board=False, ground_texture=12.0))))
    (pb / "traffic" / "tiny_odometry.json").write_text(json.dumps(
        {"entry": "chain_poses", "clips": 2, "checks": checks, "pipeline": {"keyframe": {"window": 21}}}))
    (pb / "checks" / "tiny_odometry.json").write_text(json.dumps(
        {"limits": json.loads((pb / "checks" / "odometry_720p.json").read_text())["limits"]}))
    bench["configs"].append({"name": "tiny_markerless", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny_markerless.json", "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny_odometry", "config": "tiny_markerless", "traffic": "tiny_odometry",
                               "chips": 1, "why": "tests"})
    bench["configs"].append({"name": "tiny_board", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny_board.json", "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny_known", "config": "tiny_board", "traffic": "tiny_known", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        for real, tiny in (("board_known_1080p", "tiny_known"), ("odometry_720p", "tiny_odometry")):
            if real in m.get("workloads", ()):
                m["workloads"].append(tiny)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
