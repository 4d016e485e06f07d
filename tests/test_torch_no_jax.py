"""The port loads neither JAX nor OpenCV, and never leaves the device it
was given: ``process(device="cuda")`` raises where there is no CUDA."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import meatmodeler_tpu_torch
from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
from meatmodeler_tpu_torch.ops import clahe, orb
scene = TurntableScene(image_size=(96, 72), focal=100.0, noise_sigma=1.0)
frames, poses, corners = render_sequence(scene, 6, seed=0, color=False)
assert frames.shape == (6, 72, 96) and corners.shape == (6, 12, 2)
enh = clahe.clahe(torch.from_numpy(frames.astype(np.float32)), tiles=(4, 4))
feats = orb.detect_and_compute(enh, max_features=64, num_levels=1)
assert feats.descriptors.shape == (6, 64, 256)
import meatmodeler_tpu_torch.pipeline  # noqa: F401
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cv2"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_or_cv2():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=str(REPO), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_source_has_no_jax_or_cv2_imports():
    import re

    pat = re.compile(r"^\s*(import|from) (jax|cv2)\b", re.M)
    files = list((REPO / "meatmodeler_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders


def test_process_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from meatmodeler_tpu.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu_torch.pipeline import process

    frames, _, corners = render_sequence(TurntableScene(image_size=(96, 72), focal=100.0), 4, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        process(frames, known_corners=corners, device="cuda")
