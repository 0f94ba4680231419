"""The public surface of the port against the JAX package's, read by AST
(neither package is imported).

Each public top-level name (function, class or assignment, not starting
with "_") of a module of cat_tpu/ must have a counterpart of the same name
in the port's module of the same path (ops/pgs_pallas.py -> ops/pgs.py),
unless it is one of BY_DESIGN below. Whoever adds a public name to either
package then ports it or lists it here with its reason.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF, PORT = REPO / "cat_tpu", REPO / "cat_tpu_torch"
# the reference module -> the port's, where the path differs
RENAMED = {"ops/pgs_pallas.py": "ops/pgs.py"}

BY_DESIGN = {
    # a method of the port's ConstraintSet (tests/test_torch_env.py)
    "envs/cat.py": {"curriculum_max_p"},
    # the TPU's tiling and XLA mirror: the port's plain versions
    # (pgs_bj_reference, pgs_gs_reference) and wrappers (pgs_bj, pgs_gs)
    "ops/pgs_pallas.py": {"TILE_N", "pick_tile", "pgs_lanes_xla_bj",
                          "pgs_solve_batched", "pgs_solve_lanes",
                          "pgs_solve_lanes_bj"},
    # JAX's mesh: the port trains one process a card (torch.distributed)
    "parallel/distributed.py": {"ENV_AXIS", "make_global_mesh",
                                "host_local_to_global"},
    "parallel/mesh.py": {"ENV_AXIS", "make_mesh", "make_train_fn",
                         "shard_states"},
    # the port's PPO is stateful
    "rl/ppo.py": {"TrainState"},
    # resolve_device turns TF32 off for the whole process
    "sim/dynamics.py": {"f32_matmuls"},
    # make_batched_step returns the control step in both packages
    "sim/engine.py": {"control_step"},
    # the TPU's env-last layout: the port has one layout, envs leading
    "sim/engine_lanes.py": {"control_step_lanes"},
    "sim/dynamics_lanes.py": {
        "ContactsL", "JacsL", "KinL", "bias_forces_lanes",
        "body_jacobians_lanes", "cholesky_factor_lanes",
        "cholesky_inverse_lanes", "cross_l", "dense_inverse_lanes",
        "detect_contacts_lanes", "detect_pair_contacts_lanes", "fk_lanes",
        "inv3_lanes", "mass_matrix_inverse_lanes", "mass_matrix_lanes",
        "matmat3_l", "matvec3_l", "quat_integrate_l", "quat_mul_l",
        "quat_rotate_l", "quat_to_mat_l", "skew_l", "transpose3_l",
        "world_inertias_lanes"},
}


def public_names(path: Path) -> set:
    """Public top-level names of a module: functions, classes, assigned
    names."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def ref_modules():
    return sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def missing(rel: str) -> set:
    """The public names of cat_tpu/<rel> the port's module lacks."""
    port = PORT / RENAMED.get(rel, rel)
    have = public_names(port) if port.exists() else set()
    return public_names(REF / rel) - have


@pytest.mark.parametrize("rel", ref_modules())
def test_every_public_name_has_a_counterpart(rel):
    assert missing(rel) == BY_DESIGN.get(rel, set())


def test_by_design_list_names_reference_modules():
    """Every module of the list exists in cat_tpu/, and only the lanes
    modules have no counterpart module in the port."""
    assert set(BY_DESIGN) <= set(ref_modules())
    without = {rel for rel in ref_modules()
               if not (PORT / RENAMED.get(rel, rel)).exists()}
    assert without == {"sim/engine_lanes.py", "sim/dynamics_lanes.py"}


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax or cat_tpu."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            bad += [f"{path.relative_to(REPO)}: {m}" for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "cat_tpu")]
    assert bad == []
