"""The port's committed dry-run records (the counterpart of the first test
of ``tests/test_dryrun_artifacts.py``).

``experiments/torch_dryrun/<mesh>/<arch>__<shape>.json`` is written by
``python -m repro_torch.launch.dryrun --all --both-meshes`` (and the
solver's record by ``python -m repro_torch.launch.dryrun_solver
--both-meshes``).  Every (arch x shape x mesh) cell traced (``status``
"ok", ``trace_s`` > 0) or is the documented skip, its ``reason``
``skip_reason``'s own string.  A missing record fails: the records are
committed.  The JAX test's second one, the peak under a v5e chip's 16 GB,
has no counterpart: that is a TPU's bound (the per-rank peaks above an
H100's 80 GB are an open item of ROADMAP C35).
"""
import json
from pathlib import Path

import pytest

from repro_torch.configs import ARCH_IDS, SHAPES, skip_reason

RECORDS = Path(__file__).resolve().parent.parent / "experiments" \
    / "torch_dryrun"
MESHES = ("pod16x16", "pod2x16x16")
SOLVER = "solver-p-bicgsafe__poisson2048x1024x1024.json"


def load(mesh: str, name: str) -> dict:
    path = RECORDS / mesh / name
    assert path.exists(), f"no record {path}"
    return json.loads(path.read_text())


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cell_traced_or_documented_skip(mesh, arch, shape):
    rec = load(mesh, f"{arch}__{shape}.json")
    assert (rec["arch"], rec["shape"], rec["mesh"]) == (arch, shape, mesh)
    expected_skip = skip_reason(arch, shape)
    if expected_skip:
        assert rec["status"] == "skip"
        assert rec["reason"] == expected_skip
    else:
        assert rec["status"] == "ok", rec.get("error", "")[:500]
        assert rec["trace_s"] > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_solver_cell_traced(mesh):
    rec = load(mesh, SOLVER)
    assert rec["status"] == "ok", rec.get("error", "")[:500]
    assert rec["collectives"]["counts"]["all-reduce"] > 0
