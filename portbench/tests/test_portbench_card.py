"""On the card only (``-m card``; each skips without one): the control, the
reference one precision below the configuration's in the program's place,
comes out not correct at a size a test run holds, on three seeds; and one
short run of each cell's command is correct.

    python3 -m pytest portbench/tests -m card -q
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_benchmark(ROOT)
CELLS = [c["name"] for c in BENCH["workloads"]]
SMALL = {"sample": {"batch": 4, "keep_calls": 1}, "transfer": {"starts": 4, "keep_calls": 1},
         "stage1_train": {"batch": 4}}


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload, cuda):
    cell = harness.find_cell(BENCH, workload)
    cfg = harness.config_of(BENCH, ROOT, cell["config"])
    traffic = harness.traffic_of(ROOT, cell["traffic"])
    small = dict(traffic, **SMALL[traffic["runner"]])
    module = harness.runner_of(ROOT, traffic["runner"])
    for seed in (11, 12, 13):
        got = module.Runner(cfg, small, seed, cuda).control()
        assert any(got[k] > float(v) for k, v in traffic["limits"].items()), (seed, got)
        harness.free(cuda)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct(workload, cuda):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", "4000000001", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
