"""Logical-axis sharding on ``torch.distributed`` device meshes (PyTorch
port of ``repro.parallel``): DTensor placements from the JAX package's
rules."""
from . import strategies  # noqa: F401  registers the missing strategies
from .param_rules import module_param_specs, spec_for_param, tree_param_specs
from .sharding import (DEFAULT_RULES, LogicalMesh, PartitionSpec,
                       current_mesh, logical_constraint, param_spec,
                       set_mesh, use_mesh)

__all__ = ["LogicalMesh", "current_mesh", "logical_constraint",
           "param_spec", "set_mesh", "use_mesh", "DEFAULT_RULES",
           "PartitionSpec", "spec_for_param", "tree_param_specs",
           "module_param_specs"]
