"""Property-based tests (hypothesis) for the port's solve service: for a
drawn request stream (mixed operators, tolerances and budgets, any slot
and chunk geometry, either substrate), every request the port's engine
serves is the JAX engine's (``"jnp"``, ROADMAP C1) on the same stream: the
same status, iterations within ±2, ``x`` within 1e-6 (ROADMAP C4), chunks
resident within ±1.  Streams are longer than the slot count, so some
requests always enter through a mid-flight refill.  Few examples: each
runs both engines."""
import pytest

hypothesis = pytest.importorskip("hypothesis")
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads
import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from conftest import enable_x64  # noqa: E402
from repro.core import matrices as JM  # noqa: E402
from repro.service import ServiceConfig as JServiceConfig  # noqa: E402
from repro.service import SolveEngine as JSolveEngine  # noqa: E402
from repro_torch.core import matrices as TM  # noqa: E402
from repro_torch.service import ServiceConfig, SolveEngine  # noqa: E402

SETTINGS = dict(max_examples=4, deadline=None,
                suppress_health_check=[hypothesis.HealthCheck.too_slow])


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**10),
       n_req=st.integers(4, 8),
       max_batch=st.sampled_from([2, 3, 4]),
       chunk=st.sampled_from([3, 8, 64]),
       substrate=st.sampled_from(["torch", "cuda"]))
def test_engine_stream_matches_jax(seed, n_req, max_batch, chunk, substrate):
    repro_torch.clear_session_cache()
    with enable_x64(True):
        gens = {"a": ("poisson3d", {}), "b": ("convection_diffusion",
                                             dict(peclet=1.0))}
        scfg = dict(max_batch=max_batch, chunk=chunk, tol=1e-8, maxiter=300)
        jeng = JSolveEngine(JServiceConfig(substrate="jnp", **scfg))
        teng = SolveEngine(ServiceConfig(substrate=substrate, device="cpu",
                                         **scfg))
        for name, (gen, kw) in gens.items():
            jeng.register(getattr(JM, gen)(6, **kw)[0], name=name)
            teng.register(getattr(TM, gen)(6, **kw, device="cpu")[0],
                          name=name)
        rng = np.random.default_rng(seed)
        for _ in range(n_req):
            opn = str(rng.choice(["a", "b"]))
            b = rng.standard_normal(216)
            kw = dict(tol=float(rng.choice([1e-4, 1e-8])),
                      maxiter=int(rng.choice([9, 300])))
            assert jeng.submit(opn, jnp.asarray(b), **kw) == \
                teng.submit(opn, b, **kw)
        jres = {r.rid: r for r in jeng.run()}
        tres = {r.rid: r for r in teng.run()}
    assert sorted(jres) == sorted(tres) == list(range(n_req))
    for rid, j in jres.items():
        t = tres[rid]
        assert t.status == j.status and t.converged == j.converged, rid
        assert abs(t.iterations - j.iterations) <= 2, rid
        assert np.max(np.abs(t.x - np.asarray(j.x))) <= 1e-6, rid
        assert abs(t.telemetry.chunks_resident
                   - j.telemetry.chunks_resident) <= 1, rid
    assert teng.stats["runs"] == teng.stats["host_reads"] \
        == teng.stats["chunks"]
