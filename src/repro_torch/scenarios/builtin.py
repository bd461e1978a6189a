"""The seed operator classes, registered from :mod:`repro_torch.core
.matrices` (PyTorch port of ``repro.scenarios.builtin``).

ONE definition per problem family: the sweep, the audit and the tests
build their operators through these plugins (:func:`repro_torch.scenarios
.build_problem`), on the device they are asked for.  The generators stay
where they are; these plugins are the registry's (cached, spec-addressed)
view onto them.

All seed classes satisfy the paper's expected contract matrix as they are
(``contract_overrides`` empty); the stencil families are mesh-capable (the
row-sharded halo format).
"""
from __future__ import annotations

from ..core import matrices
from .registry import register_operator_class


@register_operator_class("poisson3d", mesh_capable=True,
                         description="SPD 7-point Laplacian (poisson3Db "
                         "kind)")
def _poisson3d(device=None, **kw):
    return matrices.poisson3d(device=device, **kw)


@register_operator_class("convection_diffusion", mesh_capable=True,
                         description="non-symmetric convection-diffusion "
                         "stencil (atmosmodd kind)")
def _convection_diffusion(device=None, **kw):
    return matrices.convection_diffusion(device=device, **kw)


@register_operator_class("anisotropic3d", mesh_capable=True,
                         description="badly scaled SPD stencil "
                         "(s3dkq4m2 kind)")
def _anisotropic3d(device=None, **kw):
    return matrices.anisotropic3d(device=device, **kw)


@register_operator_class("random_nonsym",
                         description="random sparse non-symmetric "
                         "CSR/ELL (xenon2 kind)")
def _random_nonsym(device=None, **kw):
    return matrices.random_nonsym(device=device, **kw)


@register_operator_class("hard_nonsym",
                         description="ill-conditioned non-symmetric "
                         "dense (sherman3 kind, paper §5.2)")
def _hard_nonsym(device=None, **kw):
    return matrices.hard_nonsym(device=device, **kw)


@register_operator_class("spd_dense",
                         description="small dense SPD with prescribed "
                         "condition number")
def _spd_dense(device=None, **kw):
    return matrices.spd_dense(device=device, **kw)


@register_operator_class("nonsym_dense",
                         description="small dense non-symmetric, "
                         "well-conditioned")
def _nonsym_dense(device=None, **kw):
    return matrices.nonsym_dense(device=device, **kw)
