"""Launchers of the port: mesh construction, sharding rules, step
builders, the dry run, and the train/serve CLIs."""
from .mesh import make_local_mesh, make_production_mesh
from .sharding import pick_policy, tree_shardings
from .steps import (
    StepBundle,
    build_prefill_step,
    build_serve_step,
    build_train_step,
)

__all__ = [
    "make_production_mesh", "make_local_mesh",
    "pick_policy", "tree_shardings",
    "StepBundle", "build_train_step", "build_serve_step",
    "build_prefill_step",
]
