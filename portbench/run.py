"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's files are found by name
(``portbench/spec.py``). Set-up imports torch, loads the program's kernel
libraries and native host code in parallel (built into
``build/meatmodeler_tpu_torch/`` on a checkout's first run), renders the
cell's distinct clips on the card from ``--seed`` and runs each once. Then a
closed loop with one client calls the entry point on the clips in turn for
``--seconds``; the call running when the time is up runs to its end and
counts. After the window, the peak device memory is read, a sample of the
calls drawn from the seed is judged against the plain reference
(``portbench/reference/``), and each number compared is printed beside its
limit, last on standard error and last in the result line.

``--trace 0`` reports the cell's end-to-end metrics. ``--trace 1`` runs the
window with the program's stages synchronised (``MEATMODELER_SYNC_STAGES``),
then one call of each clip under ``torch.profiler``, and reports the cell's
per-layer metrics with the device's busy and window seconds and a
breakdown. The last line of standard output is one JSON object; a run on a
machine without the CUDA devices the cell asks for prints none and exits 2.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

from portbench import spec  # noqa: E402

__all__ = ["FORBIDDEN", "main", "measure", "window", "rate"]

# Top-level module names the process must not hold once the window closed:
# the JAX package beside the port, JAX itself and the JAX package's bench.
FORBIDDEN = ("jax", "jaxlib", "flax", "meatmodeler_tpu", "bench")
# The program's kernel libraries (``build()``) and native host code
# (``_native.load()``), loaded in parallel during set-up.
KERNEL_MODULES = (
    "meatmodeler_tpu_torch.ops.clahe_cuda", "meatmodeler_tpu_torch.ops.klt_cuda",
    "meatmodeler_tpu_torch.geometry.ransac_cuda", "meatmodeler_tpu_torch.geometry.ransac_hyp_cuda",
    "meatmodeler_tpu_torch.solvers.bundle_adjust_cuda", "meatmodeler_tpu_torch.geometry.pnp_cuda",
    "meatmodeler_tpu_torch.geometry.calibration_cuda",
)
NATIVE_MODULES = ("meatmodeler_tpu_torch.io.native_pass1", "meatmodeler_tpu_torch.io.native_ops")


def forbidden_modules() -> list:
    return sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)


def _cache_dirs(root) -> None:
    """Kernel caches at fixed paths inside the checkout."""
    base = os.path.join(str(root), "build", "portbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")


def _load_libraries() -> None:
    import importlib

    def load(name):
        module = importlib.import_module(name)
        return module.build() if hasattr(module, "build") else module._native.load()

    with ThreadPoolExecutor(len(KERNEL_MODULES) + len(NATIVE_MODULES)) as pool:
        list(pool.map(load, KERNEL_MODULES + NATIVE_MODULES))


def rate(calls) -> float:
    """Frames per second of a window: the frames of every call that
    completed and was not judged wrong, over the seconds from the window's
    start to the end of its last call. ``calls``: (start s, end s, frames,
    ok) from the window's start."""
    if not calls:
        return 0.0
    span = max(end for _, end, _, _ in calls) - min(start for start, _, _, _ in calls)
    return sum(frames for _, _, frames, ok in calls if ok) / span if span > 0 else 0.0


def window(runner, clips, seconds: float, sample: int, rng: random.Random):
    """The closed loop: call the entry on the clips in turn until
    ``seconds`` have passed; the last call runs to its end. Keeps a uniform
    sample of ``sample`` completed calls' records for the check (reservoir
    sampling with ``rng``); of every other call it keeps only the host
    summary the end-to-end and per-layer numbers need
    (``runner.summarize``) and releases the record. Returns (the summaries
    of the calls that completed, the calls' (start, end, frames, completed)
    from the window's start, each call's process CPU seconds, the sample as
    (call index, record), errors)."""
    summaries, calls, cpu, kept, errors = [], [], [], [], []
    t_start = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t_start < seconds:
        clip = clips[i % len(clips)]
        t0, c0 = time.perf_counter() - t_start, time.process_time()
        try:
            rec = runner.run(clip)
        except Exception:  # a failed call counts as failed; the loop goes on
            errors.append(traceback.format_exc())
            calls.append((t0, time.perf_counter() - t_start, runner.frames(clip), False))
            cpu.append(time.process_time() - c0)
            i += 1
            continue
        calls.append((t0, time.perf_counter() - t_start, runner.frames(clip), True))
        cpu.append(time.process_time() - c0)
        summaries.append(runner.summarize(rec))
        if len(kept) < sample:
            kept.append((i, rec))
        else:
            j = rng.randrange(len(summaries))
            if j < sample:
                kept[j][1].release()
                kept[j] = (i, rec)
            else:
                rec.release()
        i += 1
    return summaries, calls, cpu, kept, errors


def host_state() -> dict:
    """What the host's CPUs were doing: the cumulative CPU seconds that the
    hypervisor took from this machine (``steal``) and that every core spent
    busy, the load average, the cores this process may use, the frequency
    governor and the cores' mean clock. Read before and after the window,
    to tell a host that slowed the calls from a harness that did."""
    out = {"cores_allowed": len(os.sched_getaffinity(0)), "load_1min": os.getloadavg()[0]}
    try:
        with open("/proc/stat") as f:
            fields = [int(x) for x in f.readline().split()[1:]]
        hz = os.sysconf("SC_CLK_TCK")
        out["steal_s"] = fields[7] / hz if len(fields) > 7 else None
        out["busy_s"] = (sum(fields[:8]) - fields[3] - fields[4]) / hz
    except (OSError, ValueError):
        pass
    try:
        with open("/sys/devices/system/cpu/cpu0/cpufreq/scaling_governor") as f:
            out["governor"] = f.read().strip()
    except OSError:
        out["governor"] = None
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
        out["mhz_mean"] = sum(mhz) / len(mhz) if mhz else None
    except (OSError, ValueError):
        pass
    return out


def _per_layer(cell, runner, clips, summaries) -> tuple:
    from portbench import trace

    readers = {m["name"]: spec.metric_module(cell, m["name"]) for m in cell.per_layer}
    targets = sorted({t for r in readers.values() for t in getattr(r, "RECORD", ())})
    traced_records, summary, recorded = trace.traced(runner.run, clips, targets)
    for rec in traced_records:
        rec.release()
    ctx = {"rows": runner.layer_rows(summaries), "trace": summary, "recorded": recorded}
    metrics = {}
    for m in cell.per_layer:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    def short(name):
        """A kernel's name without its trailing argument list."""
        if name.endswith(")"):
            depth = 0
            for i in range(len(name) - 1, -1, -1):
                depth += {")": 1, "(": -1}.get(name[i], 0)
                if depth == 0:
                    name = name[:i]
                    break
        return name[:200]

    breakdown = {
        "device_ops": [[short(k), v] for k, v in sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[k, v] for k, v in sorted(summary["idle_s"].items(), key=lambda kv: -kv[1])[:10]],
    }
    return metrics, summary, breakdown


def measure(cell, seed: int, seconds: float, traced: bool, device) -> dict:
    """One run of ``cell`` on ``device`` (set-up, window, check); returns
    the result object. The chip check is the caller's."""
    import torch

    device = torch.device(device)
    t_import = time.perf_counter() - T0
    if device.type == "cuda":
        _load_libraries()
    t_libs = time.perf_counter() - T0
    runner = spec.entry_module(cell).Runner(cell.config, cell.traffic, device)
    clips = runner.inputs(seed)
    t_render = time.perf_counter() - T0
    for clip in clips:
        runner.run(clip).release()
    setup_s = time.perf_counter() - T0
    print(f"setup_s {setup_s}: import {t_import}, libraries {t_libs - t_import}, render {t_render - t_libs}, "
          f"warm-up {setup_s - t_render}")

    if traced:
        os.environ["MEATMODELER_SYNC_STAGES"] = "1"
    host_before = host_state()
    try:
        summaries, calls, cpu, kept, errors = window(runner, clips, seconds, int(cell.traffic["checks"]),
                                                     random.Random(seed))
    finally:
        os.environ.pop("MEATMODELER_SYNC_STAGES", None)
    host_after = host_state()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    leaked = forbidden_modules()
    print(f"calls (s, in turn over {len(clips)} clips): {[round(end - start, 4) for start, end, _, _ in calls]}",
          file=sys.stderr)
    print(f"calls' process CPU s: {[round(c, 4) for c in cpu]}", file=sys.stderr)
    print(f"host before the window: {json.dumps(host_before)}; after: {json.dumps(host_after)}", file=sys.stderr)

    result = {"correct": False, "attempted": len(calls), "failed": len(errors), "metrics": {}, "device": {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1, "memory_peak_bytes": int(peak),
    }}
    if traced:
        metrics, summary, result["breakdown"] = _per_layer(cell, runner, clips, summaries)
        result["metrics"] = metrics
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])

    # The check, once the window has closed and the peak is read.
    worst = {name: 0.0 for name in cell.limits}
    wrong = 0
    for index, rec in kept:
        nums = runner.numbers(rec)
        print(f"check of clip seed {rec.clip.seed}: {json.dumps(nums)}; {json.dumps(runner.diagnostics(rec))}",
              file=sys.stderr)
        bad = False
        for name, limit in cell.limits.items():
            value = nums[name]
            worst[name] = max(worst[name], value) if not math.isnan(value) else math.inf
            bad |= not value <= limit
        if bad:
            wrong += 1
            start, end, frames, _ = calls[index]
            calls[index] = (start, end, frames, False)
        rec.release()
    for err in errors[:3]:
        print(err, file=sys.stderr)
    if leaked:
        print(f"modules that must not be loaded: {leaked}", file=sys.stderr)
    result["failed"] += wrong
    result["correct"] = bool(kept) and not errors and not wrong and not leaked

    if not traced:
        values = {"setup_s": setup_s, "fps": rate(calls), **runner.end_to_end(summaries)}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    result["checks"] = {name: {"value": worst[name], "limit": limit} for name, limit in cell.limits.items()}
    runner.close()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = spec.REPO
    cell = spec.resolve(args.workload, root)
    _cache_dirs(root)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import meatmodeler_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the program is not in this checkout: {exc}", file=sys.stderr)
        return 3
    result = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    leaked = forbidden_modules()
    if leaked:
        print(f"portbench: modules that must not be loaded: {leaked}; no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
