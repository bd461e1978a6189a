"""The port's logical-axis sharding (``repro_torch.parallel``, the models'
``cache_logical_axes``) held against the JAX package on the CPU, in this
process (the spawned gloo worlds that train on a mesh are in
``tests/test_torch_parallel_mesh.py``).

* ``spec_for_param`` / ``tree_param_specs`` leaf by leaf against the JAX
  package's, for every config at full width (the JAX
  ``jax.eval_shape(init_params)`` tree, shapes only; JAX's side on an
  ``AbstractMesh``, the port's on a ``DeviceMesh`` made without a process
  group) on the meshes (16, 16) ("data", "model"), (2, 16, 16) ("pod",
  "data", "model"), (2, 4) and (8,) ("data",).
* ``module_param_specs`` on every smoke model's parameters against the
  JAX stacked leaves, less the layer axis.
* ``placements`` against hand-written DTensor placements; the
  constraints' divisibility fallback against the JAX rule.
* ``logical_constraint`` bitwise the identity on a plain tensor and with
  no mesh; on DTensors of a one-rank gloo mesh, the placements asked for.
* ``use_mesh`` nesting and restoring.
* ``cache_logical_axes`` against the JAX package's for every family, the
  SSM family's ``s_m`` the one intended difference (ROADMAP C28).
"""
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import cache_logical_axes as jcache_axes  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.parallel import LogicalMesh as JLogicalMesh  # noqa: E402
from repro.parallel import logical_constraint as jconstraint  # noqa: E402
from repro.parallel.param_rules import \
    tree_param_specs as jtree_specs  # noqa: E402
from repro.parallel.sharding import DEFAULT_RULES as JRULES  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, smoke_config  # noqa: E402
from repro_torch.models import cache_logical_axes, init_cache  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.transformer import param_path  # noqa: E402
from repro_torch.parallel import (DEFAULT_RULES, LogicalMesh,  # noqa: E402
                                  PartitionSpec, current_mesh,
                                  logical_constraint, module_param_specs,
                                  param_spec, set_mesh, spec_for_param,
                                  tree_param_specs, use_mesh)
from repro_torch.parallel.sharding import constraint_spec  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import (Replicate, Shard,  # noqa: E402
                                      distribute_tensor)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "8": ((8,), ("data",))}


def torch_mesh(name: str) -> LogicalMesh:
    """The port's mesh: a DeviceMesh of the shape with no process group
    (specs and placements read only its shape and names)."""
    shape, names = MESHES[name]
    n = int(np.prod(shape))
    return LogicalMesh(DeviceMesh("cpu", torch.arange(n).reshape(shape),
                                  mesh_dim_names=names, _init_backend=False,
                                  _rank=0))


def jax_mesh(name: str) -> JLogicalMesh:
    shape, names = MESHES[name]
    return JLogicalMesh(AbstractMesh(shape, names))


_SHAPES = {}


def jax_shapes(arch: str, smoke: bool):
    """The JAX parameter tree's shapes (``jax.eval_shape``), once a
    config."""
    key = (arch, smoke)
    if key not in _SHAPES:
        cfg = jsmoke(arch) if smoke else jget_config(arch)
        _SHAPES[key] = jax.eval_shape(
            lambda: jinit(cfg, jax.random.PRNGKey(0)))
    return _SHAPES[key]


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def entries(spec):
    return tuple(spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax_at_full_width(arch, mesh):
    shapes = jax_shapes(arch, smoke=False)
    jspecs = dict(leaves(jtree_specs(shapes, jax_mesh(mesh))))
    lm = torch_mesh(mesh)
    tspecs = dict(leaves(tree_param_specs(shapes, lm)))
    assert set(tspecs) == set(jspecs)
    sharded = 0
    for path, shape in leaves(shapes):
        want = entries(jspecs[path])
        assert entries(tspecs[path]) == want, (path, shape.shape)
        one = spec_for_param("/" + "/".join(path), shape.shape, lm)
        assert isinstance(one, PartitionSpec) and entries(one) == want
        assert param_spec("/" + "/".join(path), shape.shape, lm) == one
        sharded += any(e is not None for e in want)
    assert sharded                     # the rules place something


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_module_param_specs_are_the_stacked_leaves_less_the_layer_axis(
        arch, mesh):
    model = init_params(smoke_config(arch), torch.Generator().manual_seed(0))
    lm = torch_mesh(mesh)
    specs = module_param_specs(model, lm)
    jspecs = dict(leaves(jtree_specs(jax_shapes(arch, smoke=True),
                                     jax_mesh(mesh))))
    names = [k for k, _ in model.named_parameters()]
    assert sorted(specs) == sorted(names)
    for name in names:
        path, layer = param_path(name)
        want = entries(jspecs[path])
        assert entries(specs[name]) == (want[1:] if layer >= 0 else want), \
            name


def test_placements_are_the_hand_written_ones():
    lm = torch_mesh("2x16x16")
    R = Replicate()
    cases = {
        lm.spec("batch", None, "vocab"): (Shard(0), Shard(0), Shard(2)),
        lm.spec("fsdp", "tensor"): (R, Shard(0), Shard(1)),
        lm.spec("embed", "layers"): (R, R, R),
        PartitionSpec(): (R, R, R),
        PartitionSpec(None, "pod"): (Shard(1), R, R),
    }
    for spec, want in cases.items():
        assert lm.placements(spec) == want, spec
    assert lm.spec("batch", None, "vocab") == \
        PartitionSpec(("pod", "data"), None, "model")
    lm2 = torch_mesh("2x4")                  # no "pod": batch is "data"
    assert lm2.spec("batch", "heads") == PartitionSpec("data", "model")
    assert lm2.placements(lm2.spec("batch", "heads")) == (Shard(0), Shard(1))
    with pytest.raises(ValueError, match="mesh's order"):
        lm.placements(PartitionSpec(("data", "pod")))
    with pytest.raises(ValueError, match="twice"):
        lm.placements(PartitionSpec("model", "model"))
    with pytest.raises(TypeError, match="DeviceMesh"):
        LogicalMesh(object())
    assert lm.size("batch") == 32 and lm.size("heads") == 16 \
        and lm.size("embed") == 1 and lm2.size("batch") == 2
    assert DEFAULT_RULES == JRULES


@pytest.mark.parametrize("mesh", list(MESHES))
def test_constraint_fallback_is_the_jax_rule(mesh, monkeypatch):
    """A logical name whose axes do not divide the dimension is dropped:
    the spec the JAX constraint hands to ``with_sharding_constraint``."""
    import repro.parallel.sharding as jsharding
    lm, jlm = torch_mesh(mesh), jax_mesh(mesh)
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s.spec) or x)
    for shape, names in [((32, 64, 512), ("batch", "seq", "embed")),
                         ((2, 16, 8), ("batch", "heads", None)),
                         ((4, 3, 256), ("batch", "seq", "vocab")),
                         ((8, 4, 48, 7), ("batch", "experts", None, None))]:
        with jsharding.use_mesh(jlm):
            jconstraint(jax.ShapeDtypeStruct(shape, np.float32), *names)
        assert entries(constraint_spec(shape, names, lm)) == \
            entries(seen[-1]), (shape, names)


def test_constraint_is_the_identity_without_a_mesh_or_on_a_plain_tensor():
    x = torch.randn(4, 8, 16, generator=torch.Generator().manual_seed(0))
    assert current_mesh() is None
    y = logical_constraint(x, "batch", "seq", "embed")
    assert y is x
    with use_mesh(torch_mesh("2x4")):
        z = logical_constraint(x, "batch", "seq", "embed")
    assert z is x and torch.equal(z, x)


def test_use_mesh_nests_and_restores():
    a, b = torch_mesh("2x4"), torch_mesh("8")
    assert current_mesh() is None
    with use_mesh(a) as got:
        assert got is a and current_mesh() is a
        with use_mesh(b):
            assert current_mesh() is b
            with use_mesh(None):
                assert current_mesh() is None
            assert current_mesh() is b
        assert current_mesh() is a
        with pytest.raises(RuntimeError):
            with use_mesh(b):
                raise RuntimeError("inside")
        assert current_mesh() is a
    assert current_mesh() is None
    set_mesh(a)
    try:
        assert current_mesh() is a
    finally:
        set_mesh(None)


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A (1, 1) ("data", "model") mesh of a one-rank gloo group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield LogicalMesh(init_device_mesh("cpu", (1, 1),
                                           mesh_dim_names=("data", "model")))
    finally:
        dist.destroy_process_group()


def test_constraint_places_dtensors(one_rank_mesh):
    lm = one_rank_mesh
    t = torch.randn(4, 8, 6, generator=torch.Generator().manual_seed(1))
    x = distribute_tensor(t, lm.mesh, [Replicate(), Replicate()])
    with use_mesh(lm):
        y = logical_constraint(x, "batch", None, "heads")
        w = logical_constraint(x, None, None, None)
    assert y.placements == (Shard(0), Shard(2))
    assert w.placements == (Replicate(), Replicate())
    assert torch.equal(y.full_tensor(), t) and torch.equal(w.full_tensor(), t)
    # the constraint holds in the backward too (a redistribute's gradient)
    x.requires_grad_(True)
    with use_mesh(lm):
        g, = torch.autograd.grad(
            logical_constraint(x, "batch", None, "heads").sum(), [x])
    assert g.placements == x.placements
    assert torch.equal(g.full_tensor(), torch.ones_like(t))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_logical_axes_match_jax(arch):
    cfg = get_config(arch)
    ours, theirs = cache_logical_axes(cfg), jcache_axes(jget_config(arch))
    assert set(ours) == set(theirs)
    for key in ours:
        if cfg.family == "ssm" and key == "s_m":
            # C28: s_m is (np, B, H, hd); the JAX package names 3 axes
            assert theirs[key] == (None, "batch", None)
            assert ours[key] == (None, "batch", None, None)
        else:
            assert ours[key] == theirs[key], key
    # every entry names one axis a dimension of the cache it describes
    small = smoke_config(arch)
    cache = init_cache(small, 2, 8, device="cpu")
    axes = cache_logical_axes(small)
    assert set(cache) == set(axes)
    for key, t in cache.items():
        assert len(axes[key]) == t.dim(), key
