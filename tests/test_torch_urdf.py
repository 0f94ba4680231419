"""The port's asset pipeline (cat_tpu_torch/sim/urdf.py, RobotModel.to_json,
the compile scripts) against the JAX package's, byte for byte.

* Go2: the port's compile of its copy of go2.urdf with the compile
  script's arguments writes the same JSON as cat_tpu.sim.urdf.compile_urdf
  on the JAX package's go2.urdf (the two URDFs are byte-equal), and the
  same JSON as either package's from_json(committed go2_model.json)
  .to_json(): the committed file predates the ten pair_* fields, which a
  compile writes empty (the from_json default), and is equal in every
  field it has; a step of the raw engine on each is bit for bit the same.
* Small URDFs written here, through both compilers: a nested fixed chain
  (sites, merged inertia), a cylinder and a box (the candidate expansion),
  a continuous joint with no limit and an unnormalised axis, and rpy
  origins that are not zero; the error paths raise as the reference's do.
* The compile scripts write under --out and leave the committed JSON
  alone; the Solo12 script, whose URDF is not in the repository, exits
  non-zero.
"""

import dataclasses
import filecmp
import hashlib
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu.sim import model as jmodel
from cat_tpu.sim import urdf as jurdf
from cat_tpu_torch.models import go2 as tgo2
from cat_tpu_torch.sim import engine as tem
from cat_tpu_torch.sim import model as tmodel
from cat_tpu_torch.sim import urdf as turdf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = {"go2": "cat_tpu_torch/models/go2_model.json",
             "solo12": "cat_tpu_torch/models/solo12_model.json"}


def _reference_script():
    """tools/compile_go2.py, the reference's compile script, as a module."""
    spec = importlib.util.spec_from_file_location(
        "ref_compile_go2", os.path.join(ROOT, "tools", "compile_go2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_go2_json():
    return jurdf.compile_urdf(
        os.path.join(ROOT, "cat_tpu/models/assets/go2.urdf"), armature=0.01,
        effort_limit=23.7, velocity_limit=30.0,
        default_joint_pos=_reference_script().DEFAULT_JOINT_POS,
        default_base_pos=(0.0, 0.0, 0.34)).to_json()


def _assert_models_equal(a, b):
    """Every field equal, arrays in shape and dtype too."""
    for f in dataclasses.fields(tmodel.RobotModel):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert type(x) is type(y) and np.array_equal(x, y), f.name
        if isinstance(x, np.ndarray):
            assert (x.shape, x.dtype) == (y.shape, y.dtype), f.name


def test_field_lists_equal():
    """A plain copy of to_json is byte for byte only while the two
    RobotModels list the same fields in the same order."""
    names = [(f.name, f.type) for f in dataclasses.fields(tmodel.RobotModel)]
    assert names == [(f.name, f.type)
                     for f in dataclasses.fields(jmodel.RobotModel)]


def test_go2_compile_equals_the_jax_compile():
    assert filecmp.cmp(os.path.join(ROOT, "cat_tpu/models/assets/go2.urdf"),
                       tgo2.GO2_URDF, shallow=False)
    assert tgo2.GO2_DEFAULT_JOINT_POS == _reference_script().DEFAULT_JOINT_POS
    assert tgo2.compile_go2().to_json() == _jax_go2_json()


def test_go2_compile_equals_the_committed_json():
    """from_json(committed).to_json() in both packages is the compile's
    JSON: the committed file lacks the pair_* fields (empty in the
    compile), and every field it has is equal. One control step of the raw
    engine (GS-5, 8 envs, a perturbed target) on each model is bit for bit
    the same."""
    with open(os.path.join(ROOT, COMMITTED["go2"])) as f:
        committed = f.read()
    compiled = tgo2.compile_go2()
    fresh = compiled.to_json()
    assert tmodel.RobotModel.from_json(committed).to_json() == fresh
    assert jmodel.RobotModel.from_json(committed).to_json() == fresh
    _assert_models_equal(tgo2.go2_model(), compiled)

    n = 8
    params = tem.EngineParams(kp=tgo2.GO2_KP, kd=tgo2.GO2_KD)
    rng = np.random.default_rng(3)
    target = torch.from_numpy(
        (compiled.default_qpos_joints
         + rng.uniform(-0.2, 0.2, (n, 12))).astype(np.float32))
    mu = torch.full((n,), 0.8)
    runs = [tem.make_batched_step(m, params, device="cpu")(
                tem.make_batched_init(m, n, "cpu"), target, mu)
            for m in (tgo2.go2_model(), compiled)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert torch.isfinite(runs[0].qpos).all()


@pytest.mark.parametrize("robot", ["go2", "solo12"])
def test_json_round_trip(robot):
    """to_json of a loaded model reads back equal in every field (an empty
    (0, 3) field too: its [] reads back as (0, 3), not (0,))."""
    with open(os.path.join(ROOT, COMMITTED[robot])) as f:
        m = tmodel.RobotModel.from_json(f.read())
    _assert_models_equal(m, tmodel.RobotModel.from_json(m.to_json()))


def test_combine_inertia_matches():
    rng = np.random.default_rng(0)
    args = []
    for _ in range(2):
        a = rng.normal(size=(3, 3))
        args += [float(rng.uniform(0.1, 2)), rng.normal(size=3), a @ a.T]
    for x, y in zip(tmodel.combine_inertia(*args),
                    jmodel.combine_inertia(*args)):
        assert np.array_equal(x, y)


# ---- small URDFs, each through both compilers ----

def _inertial(mass, xyz="0 0 0", rpy="0 0 0", i=(0.01, 0.02, 0.03, 0.001,
                                                   -0.002, 0.0005)):
    ixx, iyy, izz, ixy, ixz, iyz = i
    return (f'<inertial><origin xyz="{xyz}" rpy="{rpy}"/>'
            f'<mass value="{mass}"/><inertia ixx="{ixx}" iyy="{iyy}" '
            f'izz="{izz}" ixy="{ixy}" ixz="{ixz}" iyz="{iyz}"/></inertial>')


def _link(name, body="", mass=0.5, com="0.01 -0.02 0.03"):
    return f'<link name="{name}">{_inertial(mass, com)}{body}</link>'


def _sphere(r, xyz="0 0 0"):
    return (f'<collision><origin xyz="{xyz}"/><geometry>'
            f'<sphere radius="{r}"/></geometry></collision>')


def _joint(name, kind, parent, child, xyz="0 0 0", rpy="0 0 0", axis=None,
           limit='<limit lower="-1.5" upper="1.2" effort="3" velocity="20"/>'):
    ax = f'<axis xyz="{axis}"/>' if axis else ""
    return (f'<joint name="{name}" type="{kind}"><parent link="{parent}"/>'
            f'<child link="{child}"/><origin xyz="{xyz}" rpy="{rpy}"/>{ax}'
            f'{limit if kind != "fixed" else ""}</joint>')


def _robot(*parts):
    return ('<?xml version="1.0"?><robot name="t">' + "".join(parts)
            + "</robot>")


URDFS = {
    # base -> revolute -> leg, then two nested fixed links merged into the
    # leg (a site each, inertia by the parallel-axis rule), the last a foot
    "nested_fixed": _robot(
        _link("base", _sphere(0.05, "0.1 0 0"), mass=2.0),
        _link("leg", _sphere(0.02)),
        _link("ankle", _sphere(0.015, "0 0 -0.01"), mass=0.1,
              com="0 0 -0.05"),
        _link("L_FOOT", _sphere(0.01), mass=0.05, com="0.001 0 0"),
        _joint("hip", "revolute", "base", "leg", xyz="0.2 0.1 0",
               axis="1 0 0"),
        _joint("ankle_fix", "fixed", "leg", "ankle", xyz="0 0 -0.16",
               rpy="0.1 0 0"),
        _joint("foot_fix", "fixed", "ankle", "L_FOOT", xyz="0 0.01 -0.03")),
    # a cylinder (two end spheres) and a rotated box (eight corners)
    "cylinder_box": _robot(
        _link("base",
              '<collision><origin xyz="0 0 0.02" rpy="0 1.5707963 0"/>'
              '<geometry><cylinder radius="0.03" length="0.4"/></geometry>'
              '</collision>'
              '<collision><origin xyz="0.05 0 -0.01" rpy="0.2 -0.1 0.3"/>'
              '<geometry><box size="0.3 0.2 0.05"/></geometry></collision>',
              mass=1.5),
        _link("arm", _sphere(0.02, "0 0 -0.1")),
        _joint("shoulder", "revolute", "base", "arm", xyz="0 0.1 0",
               axis="0 1 0")),
    # a continuous joint with no limit element and an unnormalised axis
    "continuous": _robot(
        _link("base", _sphere(0.05), mass=1.0),
        _link("wheel", _sphere(0.04)),
        _joint("spin", "continuous", "base", "wheel", xyz="0 0.2 0",
               axis="0 2 1", limit="")),
    # rpy origins that are not zero on joints, inertials and geoms
    "rpy": _robot(
        _link("base", _sphere(0.05, "0.1 0.02 0"), mass=1.0),
        '<link name="upper">'
        + _inertial(0.4, "0.01 0 -0.05", "0.3 -0.2 0.1")
        + '<collision><origin xyz="0 0 -0.08" rpy="0.4 0.5 -0.6"/>'
          '<geometry><sphere radius="0.02"/></geometry></collision></link>',
        _link("lower", _sphere(0.015, "0 0 -0.1")),
        _joint("j1", "revolute", "base", "upper", xyz="0.2 -0.1 0.05",
               rpy="0.3 -0.7 1.1", axis="0 0 1"),
        _joint("j2", "revolute", "upper", "lower", xyz="0 0 -0.16",
               rpy="-0.25 0.5 0.05", axis="0 1 0")),
}


@pytest.mark.parametrize("name", sorted(URDFS))
def test_small_urdf_compiles_as_the_jax_package(tmp_path, name):
    path = tmp_path / f"{name}.urdf"
    path.write_text(URDFS[name])
    kw = dict(armature=0.02, default_joint_pos={"hip": 0.3, "j2": -0.4},
              default_base_pos=(0.0, 0.0, 0.25))
    port, ref = turdf.compile_urdf(str(path), **kw), jurdf.compile_urdf(
        str(path), **kw)
    assert port.to_json() == ref.to_json()
    _assert_models_equal(port, tmodel.RobotModel.from_json(port.to_json()))
    # the case's point is in the model
    if name == "nested_fixed":
        assert port.site_names == ("ankle", "L_FOOT")
        assert list(port.site_body) == [1, 1]
        assert [port.report_names[i] for i in port.foot_report_ids] == [
            "L_FOOT"]
        assert port.mass[1] == pytest.approx(0.65)
    elif name == "cylinder_box":
        assert port.ncand == 2 + 8 + 1
        assert list(port.cand_radius[2:10]) == [0.0] * 8
    elif name == "continuous":
        assert port.joint_limit_lower[0] == -1e9
        np.testing.assert_allclose(np.linalg.norm(port.joint_axis[1]), 1.0)


BAD = {
    "ambiguous_root": (AssertionError, _robot(
        _link("a"), _link("b"), _link("c"),
        _joint("j", "revolute", "a", "c", axis="1 0 0"))),
    "revolute_below_fixed": (AssertionError, _robot(
        _link("base"), _link("mid"), _link("end"),
        _joint("fix", "fixed", "base", "mid"),
        _joint("j", "revolute", "mid", "end", axis="1 0 0"))),
    "prismatic": (ValueError, _robot(
        _link("base"), _link("slider"),
        _joint("p", "prismatic", "base", "slider", axis="1 0 0"))),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_error_paths_match_the_jax_package(tmp_path, name):
    kind, text = BAD[name]
    path = tmp_path / f"{name}.urdf"
    path.write_text(text)
    msgs = []
    for compile_urdf in (turdf.compile_urdf, jurdf.compile_urdf):
        with pytest.raises(kind) as e:
            compile_urdf(str(path))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[0]


def _sha(path):
    with open(os.path.join(ROOT, path), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_compile_scripts(tmp_path):
    before = {k: _sha(v) for k, v in COMMITTED.items()}
    out = tmp_path / "go2.json"
    r = subprocess.run([sys.executable, "-m",
                        "cat_tpu_torch.tools.compile_go2", "--out", str(out)],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("bodies=13 joints=12 cands=28 reports=")
    assert lines[1] == "total mass=15.0958 kg"
    assert lines[2] == f"wrote {out}"
    assert out.read_text() == _jax_go2_json()
    r = subprocess.run([sys.executable, "-m",
                        "cat_tpu_torch.tools.compile_solo12",
                        str(tmp_path / "absent.urdf"), "--out",
                        str(tmp_path / "solo12.json")],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode != 0 and "no Solo12 URDF" in r.stderr
    assert not (tmp_path / "solo12.json").exists()
    assert {k: _sha(v) for k, v in COMMITTED.items()} == before

