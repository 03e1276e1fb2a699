#!/usr/bin/env python3
"""The readings that the limits of a cell's check are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13

For each seed, in one process: set up the cell as a run does (the program
driven through its first calls), free it, then compare with the reference
(a) the program, (b) the control: the reference in bfloat16 in the
program's place, and (c) the reference with each planted fault in the
program's place: ``unchanged`` (a step that returns its state), ``half_batch``
(half of each batch left out, the mean over the rest), ``altered`` (one value
of the object changed where it is produced). One JSON line a seed.
Needs the card, as a run does; ``--device cpu`` runs it at whatever size
the configuration gives.
"""

import argparse
import json
import sys
import time

import run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    spec = run.load_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        start = time.perf_counter()
        session = spec["family"].setup(spec["config"], spec["traffic"], seed, args.device, spec["limits"])
        session.close()
        out = {"workload": args.workload, "seed": seed, "program": session.check()}
        out["control"] = session.check(control=True)
        for fault in ("unchanged", "half_batch", "altered"):
            out[fault] = session.check(fault=fault)
        out["seconds"] = time.perf_counter() - start
        print(json.dumps(out), flush=True)
        del session
    return 0


if __name__ == "__main__":
    sys.exit(main())
