"""The headline profiling tool's host-side parts: the device-busy sum over a
chrome trace, and its refusal to run without CUDA."""

import dataclasses
import json

import pytest
import torch

from meatmodeler_tpu_torch.tools import profile_headline

torch.set_num_threads(2)


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_device_busy_is_the_union_of_device_spans(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "ts": 5, "dur": 10},  # overlaps the first
        {"ph": "X", "cat": "gpu_memcpy", "ts": 30, "dur": 5},
        {"ph": "X", "cat": "gpu_memset", "ts": 32, "dur": 1},  # inside the copy
        {"ph": "X", "cat": "cuda_runtime", "ts": 0, "dur": 100},  # host side
        {"ph": "i", "cat": "kernel", "ts": 50},  # not a span
    ]
    busy_ms, kernels = profile_headline._device_busy(_trace(tmp_path, events))
    assert busy_ms == pytest.approx(20e-3)
    assert kernels == 2


def test_device_busy_empty_trace(tmp_path):
    assert profile_headline._device_busy(_trace(tmp_path, [])) == (0.0, 0)


def test_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA")
    out = tmp_path / "report.json"
    assert profile_headline.main(["--warm-runs", "1", "--out", str(out)]) == 2
    assert not out.exists()


def test_detector_config_is_the_default_path():
    from meatmodeler_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT

    from meatmodeler_tpu_torch.testing import from_fields

    DEFAULT_CONFIG = from_fields(JAX_DEFAULT)
    base = dataclasses.replace(DEFAULT_CONFIG, pass1_backend="host", pass2_enhance="grey")
    cfg = profile_headline.detector_config(base)
    assert (cfg.pass1_backend, cfg.pass2_enhance, cfg.chessboard.detector) == ("device", "bgr_lab", "device")
    assert (DEFAULT_CONFIG.pass1_backend, DEFAULT_CONFIG.pass2_enhance) == (cfg.pass1_backend, cfg.pass2_enhance)
    assert cfg.keyframe == base.keyframe and cfg.chessboard.pattern == base.chessboard.pattern

