"""What the benchmark loads: nothing of JAX or the JAX package anywhere, and
nothing of the port in the reference. Each check imports in a fresh
process and compares the top-level names in ``sys.modules`` whole (the
port's name begins with the JAX package's)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
JAX = ("jax", "jaxlib", "flax", "image2video_synthesis_using_cinns_tpu")
PORT = "image2video_synthesis_using_cinns_tpu_torch"


def loaded_after(code: str) -> set[str]:
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_and_what_it_runs_load_no_jax():
    code = f"""
import sys; sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(ROOT / 'portbench')!r})
import run
from portbench import harness, calibrate, count, serving, tracing, weights
bench = harness.load_benchmark(harness.ROOT)
for cell in bench["workloads"]:
    harness.runner_of(harness.ROOT, harness.traffic_of(harness.ROOT, cell["traffic"])["runner"])
for m in bench["per_layer"]:
    harness.reader_of(harness.ROOT, m["name"])
import portbench.reference.stage1, portbench.reference.flow
from {PORT}.models import facade
from {PORT}.train import stage1, stage1_step, optim
from {PORT}.data import augment
from {PORT}.ops.cuda import flow_kernel
"""
    found = loaded_after(code)
    assert not found & set(JAX), found & set(JAX)
    assert PORT in found


def test_the_reference_loads_nothing_of_the_port():
    code = f"""
import sys; sys.path.insert(0, {str(ROOT)!r})
import portbench.reference.nn, portbench.reference.decoder, portbench.reference.resnet
import portbench.reference.flow, portbench.reference.discriminators, portbench.reference.stage1
"""
    found = loaded_after(code)
    assert not found & {PORT, *JAX}


def test_the_reference_sources_import_only_torch_numpy_and_themselves():
    allowed = {"torch", "numpy", "math", "dataclasses", "typing", "__future__"}
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # relative: the reference itself
                    continue
                names = [node.module]
            else:
                continue
            assert {n.split(".")[0] for n in names} <= allowed, (path.name, names)


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "bair-sample-b32",
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT),
                              "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
