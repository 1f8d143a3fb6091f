"""Readings that set a cell's limits: the program's compared numbers over
many seeds, the control's, and (training) a fault's, each seed in turn in
one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 --what program
    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 --what control
    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 --what half

``program`` builds the cell's program from each seed, runs ``keep_calls``
calls (serving) or its checked steps (training) and compares them with the
reference, as a benchmark run does after its window. ``control`` puts the
reference, one precision below the configuration's, in the program's place.
``half`` (training) puts the reference on half of each batch in its place.
Each reading is printed as one JSON line. Runs on the card only.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", choices=("program", "control", "half"), required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.config_of(bench, ROOT, cell["config"])
    traffic = harness.traffic_of(ROOT, cell["traffic"])
    module = harness.runner_of(ROOT, traffic["runner"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = module.Runner(cfg, traffic, seed, device)
        if args.what == "program":
            drv.setup(harness.Phases(t0))
            if drv.loop == "closed":
                for i in range(int(traffic["keep_calls"])):
                    drv.call(i)
            got = {name: v for name, v, _ in drv.check()}
        elif args.what == "control":
            got = drv.control()
        else:
            got = drv.fault_half()
        print(json.dumps({"workload": args.workload, "what": args.what, "seed": seed,
                          "seconds": round(time.perf_counter() - t0, 2), **got}), flush=True)
        del drv
        harness.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
