#!/usr/bin/env python3
"""One traced run of a cell, as ``run.py --trace 1`` makes it, and then the
window's idle time named by the program's own spans (lib/program.py):

    python3 portbench/gaps.py --workload fcn_resnet50.folder --seed 7 \
        --seconds 30

Standard output: the run's result line (run.py's), then one JSON line with
``idle_gaps`` (the ten longest gaps, each named by the harness's ranges
open at its middle and then by the program's), ``idle_split`` (every gap's
idle seconds by the program spans open at its middle) and
``program_ranges`` (the program's spans inside the window, by name), and
``gap_spans``: for each of the ten gaps, the program spans that overlap
it at all, with the seconds of the gap each covers.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(HERE))

from portbench.lib import harness, program  # noqa: E402


def overlaps(spans: list, s: int, e: int) -> dict[str, float]:
    """{name: seconds of [s, e] it covers} of the spans overlapping it."""
    out: dict[str, float] = {}
    for a, b, name, _ in spans:
        if a < e and b > s:
            out[name] = out.get(name, 0.0) + (min(b, e) - max(a, s)) / 1e9
    return out


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    harness.cache_env()
    cell = harness.find_cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        harness.log(f"{cell.name} needs a CUDA card: no result")
        return 3
    device = torch.device("cuda", 0)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        outcome = harness.driver_for(cell).run(harness.Run(
            cell=cell, seed=args.seed, seconds=args.seconds, trace=True,
            device=device, workdir=workdir, t0=T0))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    line = harness.result_line(cell, outcome, True, {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cell.chips,
        "memory_peak_bytes": int(outcome.memory_peak_bytes)})
    harness.card_lines()
    print(json.dumps(line), flush=True)
    tr = outcome.trace
    spans = program.ranges(tr)
    counts: dict[str, int] = {}
    for *_, name, _chunk in spans:
        counts[name] = counts.get(name, 0) + 1
    print(json.dumps({"idle_gaps": program.gap_labels(tr, spans),
                      "idle_split": program.idle_split(tr, spans),
                      "program_ranges": counts,
                      "gap_spans": [overlaps(spans, s, e)
                                    for s, e in program.gaps(tr)[:10]]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
