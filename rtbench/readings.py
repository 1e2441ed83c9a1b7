#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one cell,
in one process on the card:

    python3 rtbench/readings.py --workload <cell> --seeds 1 2 ... \\
        [--control 3] [--out FILE]

For each seed, a run of the cell with a window of three whole loops (no
timing) and the check of its frames: the program's numbers. For the
first ``--control`` seeds, the control: the reference computed in
bfloat16, put in the program's place at the same frames and pixels, and
compared with the float32 reference by the same numbers. Prints one JSON
line per seed and writes them all to ``--out``. The benchmark's own runs
never run this."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if sys.path and Path(sys.path[0] or ".").resolve() == BENCH:
    sys.path[0] = str(ROOT)


def control_numbers(cell, seed: int, compared, device, dtype) -> dict:
    """The control's numbers: the reference in ``dtype`` in the program's
    place at the frames and pixels of ``compared``."""
    import torch

    from rtbench import check, run
    from rtbench.reference import scene_math
    from rtbench.reference.whitted import Reference

    meshes = [run.make_mesh(cell.bench_dir, o["mesh"], run.MESH_CACHE)
              for o in cell.config["objects"]]
    sky = run.make_sky(cell.config, seed, device, cell.bench_dir)
    ref = Reference(cell.config, meshes, torch.as_tensor(sky), device, dtype)
    gaps = []
    for c in compared:
        ref.set_history(c["history"])
        pose = c["pose"]
        got = ref.render(scene_math.basis(pose["position"], pose["yaw"], pose["pitch"]),
                         c["pixels"]).cpu().numpy()
        gaps.append(check.gaps(got, c["want"]))
    return check.numbers(gaps, cell.limits["gap_threshold"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from rtbench import manifest, run

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.Cell(manifest.load(), args.workload)
    rows = []
    for n, seed in enumerate(args.seeds):
        out = run.run_cell(cell, seed, 0.0, False, "cuda", min_loops=3,
                           log=lambda m: print(m, file=sys.stderr, flush=True))
        row = {"workload": args.workload, "seed": seed,
               "program": {k: v["value"] for k, v in out["result"]["check"].items()},
               "frames": [c["frame"] for c in out["check"]]}
        if n < args.control:
            row["control_bf16"] = control_numbers(cell, seed, out["check"], "cuda",
                                                  torch.bfloat16)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
