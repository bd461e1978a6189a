"""The dry run's grid on the (16, 16) production mesh (ROADMAP C35): each
of the 13 cells whose trace failed before the mesh repairs traces in fake
mode, at full width and shape with its depth cut
(``tests/_torch_dryrun_grid_child.py``, in ``PARTS`` child processes
at once, each a share of the cells: the fake group is process-wide
state).  The four mechanisms the cells exercise: products
whose rows fold dimensions sharded on two mesh axes (whisper, the xlstm,
zamba2, the decode scores), 40 heads split on a 16-way axis in a backward
(qwen2.5-32b, llama4), the absorbed MLA decode (deepseek-v3) and a batch
of one on the "data" axis (zamba2's long_500k).  The numbers themselves
are held elsewhere: the argument bytes against the JAX specs in
``tests/test_torch_dryrun.py``, the repaired code's values on a real
(2, 4) gloo mesh in ``tests/test_torch_parallel_mesh.py``.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402  caps torch's threads
import _torch_dryrun_grid_child as grid  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "_torch_dryrun_grid_child.py")
SRC = os.path.abspath(os.path.join(HERE, os.pardir, "src"))
SPAWN_TIMEOUT = 600
PARTS = 2


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    work = tmp_path_factory.mktemp("grid")
    env = dict(_torch_threads.child_env(threads=1),
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [work / f"cells{i}.json" for i in range(PARTS)]
    logs = [work / f"cells{i}.log" for i in range(PARTS)]
    procs = []
    for i, (out, log) in enumerate(zip(outs, logs)):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, CHILD, str(out), str(i), str(PARTS)],
                env=env, stdout=f, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=SPAWN_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * PARTS, "\n".join(
        log.read_text()[-3000:] for log in logs)
    cells = {}
    for out in outs:
        cells.update(json.loads(out.read_text()))
    return cells


@pytest.mark.parametrize("arch,shape", grid.CELLS,
                         ids=[f"{a}/{s}" for a, s in grid.CELLS])
def test_cell_traces_on_the_production_mesh(traced, arch, shape):
    rec = traced[f"{arch}/{shape}"]
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert rec["trace_s"] > 0
    mem = rec["memory"]
    assert 0 < mem["argument_size_in_bytes"] <= mem["peak_memory_in_bytes"]
    assert rec["analytic_global_flops"] > rec["per_rank_flops"] > 0
