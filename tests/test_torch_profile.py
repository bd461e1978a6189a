"""``repro_torch.observe.profile`` on the CPU: the interval math against the
JAX package's, golden timelines in the shape ``torch.profiler``'s Chrome
export has (kineto: ``cat`` "kernel" device ops, "cuda_runtime" launches
joined by ``args.correlation``, "user_annotation" ranges) analysed as the
JAX package analyses the same intervals, the kernel map, the report's JSON
in both packages, and ``profile=`` runs of the port on the CPU.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

from repro.observe import profile as JP  # noqa: E402
from repro.observe import trace as jtrace  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import SolverConfig  # noqa: E402
from repro_torch.core import _common  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402
from repro_torch.observe import profile as P  # noqa: E402
from repro_torch.observe import report  # noqa: E402
from repro_torch.service import ServiceConfig, SolveEngine  # noqa: E402

CPU = "cpu"

# a phase -> (the JAX package's HLO op name, a kernel name of the card)
NAMES = {"reduce": ("all-reduce.1",
                    "ncclDevKernel_AllReduce_Sum_f64_RING_LL(ncclDevComm*)"),
         "matvec": ("collective-permute.1",
                    "void (anonymous namespace)::spmv_ell_kernel<double>"),
         "axpy": ("fused_axpy.3",
                  "void (anonymous namespace)::fused_axpy_kernel<double>"),
         "other": ("fusion.9", "void at::native::vectorized_elementwise_"
                   "kernel<4, at::native::FillFunctor<double>>")}

#: (phase, lane, ts, dur) per golden case
GOLDEN = {
    "exposed": [("matvec", 1, 0, 100), ("reduce", 1, 100, 50),
                ("other", 1, 150, 30), ("matvec", 1, 200, 100),
                ("reduce", 1, 300, 50), ("axpy", 1, 350, 30)],
    "hidden": [("matvec", 1, 0, 100), ("reduce", 2, 10, 40),
               ("matvec", 1, 200, 100), ("reduce", 2, 220, 40)],
    "half": [("matvec", 1, 0, 100), ("reduce", 2, 50, 100)],
    "concurrent_reduce": [("reduce", 1, 0, 100), ("reduce", 2, 50, 100),
                          ("matvec", 3, 0, 20)],
    "no_reduce": [("matvec", 1, 0, 10), ("other", 1, 10, 5)],
}


def jax_doc(case):
    return {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": lane, "ts": float(ts), "dur": float(d),
         "args": {"hlo_op": NAMES[ph][0], "hlo_module": "m"}}
        for ph, lane, ts, d in GOLDEN[case]]}


def kineto_doc(case):
    return {"traceEvents": [
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7 + lane,
         "ts": float(ts), "dur": float(d), "name": NAMES[ph][1],
         "args": {"correlation": 100 + i, "stream": 7 + lane}}
        for i, (ph, lane, ts, d) in enumerate(GOLDEN[case])]}


REPORT_FIELDS = ("phase_us", "device_wall_us", "reduce_us", "matvec_us",
                 "hidden_us", "exposed_us", "overlap_efficiency",
                 "iterations", "exposed_per_iter_us", "n_device_events",
                 "unmapped_ops")


# -- interval math ------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_interval_math_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        a = [tuple(sorted(rng.uniform(0, 100, 2))) for _ in range(
            rng.integers(0, 12))]
        b = [tuple(sorted(rng.uniform(0, 100, 2))) for _ in range(
            rng.integers(0, 12))]
        ma, mb = P.merge_intervals(a), P.merge_intervals(b)
        assert ma == JP.merge_intervals(a) and mb == JP.merge_intervals(b)
        assert P.intersect_intervals(ma, mb) == JP.intersect_intervals(ma, mb)
        assert P.total(ma) == JP.total(ma)


# -- golden timelines ---------------------------------------------------------


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_timeline_reads_as_the_jax_analysis(case):
    """The same intervals as a kineto timeline (the port) and as a JAX
    profiler timeline (the reference): every number of the report
    agrees."""
    got = P.analyze_timeline(kineto_doc(case))
    want = JP.analyze_timeline(jax_doc(case))
    for field in REPORT_FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        assert g == pytest.approx(w), (field, g, w)
    expect = {"exposed": 0.0, "hidden": 1.0, "half": 0.5,
              "concurrent_reduce": 0.2 / 1.5, "no_reduce": None}[case]
    assert got.overlap_efficiency == pytest.approx(expect)


def test_kernel_map_from_an_eager_timeline():
    """A name launched inside a step under one tag maps to it; one under
    two tags, or untagged in a step, does not; launches outside every
    step teach nothing.  A graph replay's kernels (no launch ranges) are
    then classified by the map, the rest by name rules and counted as
    unmapped."""
    def launch(corr, ts):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "pid": 1, "tid": 1, "ts": ts, "dur": 1.0,
                "args": {"correlation": corr}}

    def kernel(name, corr, ts):
        return {"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                "tid": 7, "ts": ts, "dur": 2.0,
                "args": {"correlation": corr}}

    def rng_(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "pid": 1, "tid": 1, "ts": ts, "dur": dur}
    eager = {"traceEvents": [
        rng_("repro.step", 0, 100),
        rng_("repro.reduce", 1, 9), launch(1, 2), kernel("dots_k", 1, 50),
        rng_("repro.matvec", 10, 10), launch(2, 12), kernel("mv_k", 2, 52),
        launch(3, 15), kernel("add_k", 3, 54),
        rng_("repro.axpy", 30, 10), launch(4, 32), kernel("add_k", 4, 56),
        launch(5, 45), kernel("coef_k", 5, 58),
        launch(6, 150), kernel("setup_k", 6, 160),
    ]}
    kmap = P.kernel_phase_map(eager)
    assert kmap == {"dots_k": "repro.reduce", "mv_k": "repro.matvec"}
    replay = {"traceEvents": [kernel(n, 900 + i, 10.0 * i) for i, n in
                              enumerate(["dots_k", "mv_k", "add_k",
                                         "spmv_ell_kernel", "coef_k"])]}
    events = P.phase_events(replay, kmap)
    assert [e["phase"] for e in events] == ["reduce", "matvec", "other",
                                            "matvec", "other"]
    rep = P.analyze_timeline(replay, kmap)
    assert rep.unmapped_ops == 3 and rep.phase_ops["matvec"] == 2


def test_cpu_timeline_takes_top_level_operators():
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "repro.matvec",
         "pid": 1, "tid": 1, "ts": 0.0, "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mv", "pid": 1, "tid": 1,
         "ts": 1.0, "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "pid": 1,
         "tid": 1, "ts": 2.0, "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1, "tid": 1,
         "ts": 60.0, "dur": 5.0},
    ]}
    ev = P.device_events(doc)
    assert [(e["name"], e["scope"]) for e in ev] == [
        ("aten::mv", "repro.matvec"), ("aten::add", "")]


def test_report_json_loads_in_either_package(tmp_path):
    rep = P.analyze_timeline(kineto_doc("half"), label="x")
    path = rep.save(str(tmp_path / "profile.json"))
    with open(path) as fh:
        data = json.load(fh)
    assert data["schema"] == "repro.observe/profile/v1"
    jrep = JP.ProfileReport.from_json(data)
    assert jrep.overlap_efficiency == rep.overlap_efficiency
    back = P.ProfileReport.from_json(
        JP.analyze_timeline(jax_doc("half")).to_json())
    assert back.hidden_us == rep.hidden_us
    assert P.ProfileReport.load(path) == rep
    assert "overlap efficiency 0.500" in rep.render()


# -- profile= on the CPU ------------------------------------------------------


@pytest.mark.parametrize("entry", ["solve", "solve_many"])
def test_profiled_solve_writes_a_profile(tmp_path, entry):
    """The solve is warmed, taught its kernel map, profiled, and returns
    the unprofiled result bit for bit; the tags are off again after."""
    repro_torch.clear_session_cache()
    op, b, _ = TM.poisson3d(5, device=CPU)
    s = repro_torch.make_solver("p-bicgsafe", op, device=CPU,
                                config=SolverConfig(tol=1e-8, maxiter=200))
    arg = b if entry == "solve" else torch.stack([b, 0.5 * b], 1)
    bare = getattr(s, entry)(arg)
    out = str(tmp_path / entry)
    got = getattr(s, entry)(arg, profile=out, trace=True)
    assert torch.equal(got.x, bare.x)
    assert torch.equal(got.iterations, bare.iterations)
    rep = s.last_profile
    assert os.path.exists(os.path.join(out, "profile.json"))
    assert os.path.exists(os.path.join(out, "kernel_map.json"))
    assert rep.device_wall_us > 0
    for ph in ("matvec", "reduce", "axpy"):
        assert rep.phase_us[ph] > 0, ph
    assert rep.iterations == int(bare.iterations.max())
    assert rep.host_spans["repro.step"]["count"] > 0
    assert _common._TAGS == [False]
    assert P.active_capture() is None
    with P.capture(str(tmp_path / "outer")):
        with pytest.raises(RuntimeError, match="open already"):
            s.solve(b, profile=str(tmp_path / "inner"))
    assert _common._TAGS == [False]


def test_profiled_engine_run(tmp_path):
    repro_torch.clear_session_cache()
    op, _, _ = TM.poisson3d(5, device=CPU)
    out = str(tmp_path / "engine")
    eng = SolveEngine(ServiceConfig(max_batch=2, chunk=8, tol=1e-8,
                                    maxiter=300, profile_dir=out, device=CPU))
    name = eng.register(op)
    rng = np.random.default_rng(1)
    for _ in range(3):
        eng.submit(name, rng.standard_normal(op.shape[0]))
    results = eng.run()
    assert len(results) == 3 and all(r.converged for r in results)
    rep = eng.last_profile
    assert rep.label == "engine/torch" and rep.device_wall_us > 0
    assert rep.phase_us["reduce"] > 0 and rep.phase_us["matvec"] > 0
    assert rep.host_spans["engine.chunk"]["count"] >= 1
    assert P.ProfileReport.load(os.path.join(out, "profile.json")) == rep


def test_observe_cli_smoke_report_and_trajectory(tmp_path, capsys):
    """``python -m repro_torch.observe smoke`` on the CPU writes the four
    artifacts with the JAX package's schemas (its convergence JSON loads
    in the JAX ``ConvergenceTrace.from_json``), ``report`` renders them,
    ``trajectory`` says it waits for A10, and ``profile`` writes reports
    the JAX package loads and ``report`` renders."""
    repro_torch.clear_session_cache()
    out = str(tmp_path / "observe")
    assert report.main(["smoke", "--out", out, "--device", "cpu"]) == 0
    with open(os.path.join(out, "convergence.json")) as fh:
        conv = json.load(fh)
    assert conv["schema"] == "repro.observe/convergence-trace/v1"
    assert conv["summary"]["status"] == "CONVERGED"
    jtr = jtrace.ConvergenceTrace.from_json(conv)
    assert jtr.summary()["iterations"] == conv["summary"]["iterations"]
    with open(os.path.join(out, "spans.trace.json")) as fh:
        assert json.load(fh)["metadata"]["schema"] == \
            "repro.observe/chrome-trace/v1"
    with open(os.path.join(out, "metrics.json")) as fh:
        assert json.load(fh)["schema"] == \
            "repro.observe/metrics-snapshot/v1"
    assert os.path.getsize(os.path.join(out, "metrics.prom")) > 0
    capsys.readouterr()
    assert report.main(["report", "--dir", out]) == 0
    text = capsys.readouterr().out
    assert "== convergence ==" in text and "CONVERGED" in text
    assert report.main(["report", "--dir", str(tmp_path / "none")]) == 1
    assert report.main(["trajectory"]) == 2
    assert "A10" in capsys.readouterr().err
    prof = str(tmp_path / "profile")
    assert report.main(["profile", "--out", prof, "--device", "cpu"]) == 0
    for leg in ("session_torch", "engine"):
        rep = JP.ProfileReport.load(os.path.join(prof, leg, "profile.json"))
        assert rep.device_wall_us > 0, leg
    capsys.readouterr()
    assert report.main(["report", "--dir", prof]) == 0
    assert "== device profile: p-bicgsafe/torch/solve ==" in \
        capsys.readouterr().out
