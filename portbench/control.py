"""The readings that a cell's limits are set from: the program's numbers
and the control's, on many seeds, in one process.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 [--control-seeds 1,2,3] [--calls 2]

For each seed it renders the cell's clips, runs each once to warm up, then
makes ``--calls`` timed calls (at least one of each clip) as a window would,
and judges every one: the program's numbers (the lower readings), and for
the seeds in ``--control-seeds`` the control's, where the reference is put
in the program's place and computed in bfloat16 (the upper readings). One
JSON line per seed; the last line holds, per number, the largest program
reading and the smallest control reading. The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import spec

__all__ = ["readings", "main"]


def readings(cell, seeds, control_seeds, calls: int, device) -> dict:
    """Per seed the program's and the control's numbers; and the largest
    program reading and smallest control reading of each number."""
    import torch

    runner = spec.entry_module(cell).Runner(cell.config, cell.traffic, device)
    lower = {name: 0.0 for name in cell.limits}
    upper = {name: float("inf") for name in cell.limits}
    per_seed = []
    try:
        for seed in seeds:
            clips = runner.inputs(seed)
            for clip in clips:
                runner.run(clip).release()
            records = [runner.run(clips[i % len(clips)]) for i in range(max(calls, len(clips)))]
            row = {"seed": seed, "program": [runner.numbers(r) for r in records]}
            if seed in control_seeds:
                row["control"] = [runner.control_numbers(r) for r in records]
            for name in cell.limits:
                lower[name] = max([lower[name]] + [n[name] for n in row["program"]])
                upper[name] = min([upper[name]] + [n[name] for n in row.get("control", [])])
            row["diagnostics"] = [runner.diagnostics(r) for r in records]
            print(json.dumps(row), flush=True)
            per_seed.append(row)
            del records, clips
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    finally:
        runner.close()
    return {"workload": cell.workload["name"], "lower": lower, "upper": upper, "limits": cell.limits,
            "seeds": list(seeds), "control_seeds": sorted(control_seeds)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--calls", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = readings(cell, seeds, control, args.calls, "cuda")
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
