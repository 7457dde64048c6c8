"""The port's copy of the scene layer compiles AntTag to the JAX package's tables.

Bodies arrays, joint groups and contact-row tables must be EQUAL (they are
numpy on both sides), and so must the whole-step kernel's host tables:
`step_tables.joint_table`, `compile_cb_vec` and `compile_pp_vec` against the
joint table of fused.py:365-382 and fused.py's `_compile_cb_vec` /
`_compile_pp_vec`. `step_tables.build` raises ValueError on every feature the
kernel does not cover.
"""

import dataclasses

import numpy as np
import pytest

from pobrax_tpu.envs.ant_tag import extend_ant_cfg as jax_ant_tag_cfg
from pobrax_tpu.physics import fused
from pobrax_tpu.physics.system import System as JSystem
from pobrax_tpu_torch.envs.ant_tag import extend_ant_cfg as torch_ant_tag_cfg
from pobrax_tpu_torch.physics import config as tc
from pobrax_tpu_torch.physics import step_tables
from pobrax_tpu_torch.physics.system import System as TSystem
from tests.test_torch_physics import mini_cfg


@pytest.fixture(scope="module")
def pair():
    return JSystem(jax_ant_tag_cfg()), TSystem(torch_ant_tag_cfg(), device="cpu")


def assert_same(a, b, path="value"):
    """Exact structural equality of nested dicts/lists/tuples/arrays."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_configs_equal():
    assert dataclasses.asdict(jax_ant_tag_cfg()) == dataclasses.asdict(torch_ant_tag_cfg())


def test_bodies_equal(pair):
    jsys, tsys = pair
    for name in ("count", "names", "index", "mass", "inertia", "frozen", "active",
                 "active_pos", "active_rot", "inv_mass", "inv_inertia"):
        assert_same(getattr(jsys.body, name), getattr(tsys.body, name), name)
    assert (jsys.num_bodies, jsys.num_joint_dof, jsys.action_size) == (12, 8, 8)
    assert (tsys.num_bodies, tsys.num_joint_dof, tsys.action_size) == (12, 8, 8)


def test_joint_groups_equal(pair):
    jsys, tsys = pair
    assert len(jsys.joints) == len(tsys.joints) == 1
    jg, tg = jsys.joints[0], tsys.joints[0]
    for name in ("dof", "count", "names", "parent", "child", "off_p", "off_c", "q_j", "limit",
                 "stiffness", "spring_damping", "limit_strength", "angular_damping",
                 "act_idx", "act_strength", "act_kind", "default_angle"):
        assert_same(getattr(jg, name), getattr(tg, name), name)


@pytest.mark.parametrize("kind", ["point_plane", "sphere_sphere", "capsule_capsule",
                                  "capsule_box"])
def test_contact_tables_equal(pair, kind):
    jsys, tsys = pair
    a, b = getattr(jsys.contacts, kind), getattr(tsys.contacts, kind)
    assert (a is None) == (b is None)
    if a is not None:
        assert_same(a, b, kind)
    for name in ("friction", "elasticity", "baumgarte_erp", "h_sub"):
        assert getattr(jsys.contacts, name) == getattr(tsys.contacts, name)


def _fused_joint_table(sys):
    """The joint table exactly as fused.make_fused_step builds it (:365-382)."""
    joints = []
    for g in sys.joints:
        for j in range(g.count):
            joints.append(dict(
                dof=g.dof, parent=int(g.parent[j]), child=int(g.child[j]),
                off_p=tuple(float(v) for v in g.off_p[j]),
                off_c=tuple(float(v) for v in g.off_c[j]),
                q_j=tuple(float(v) for v in g.q_j[j]),
                lim=[(float(g.limit[j, d, 0]), float(g.limit[j, d, 1])) for d in range(g.dof)],
                k=float(g.stiffness[j]), kd=float(g.spring_damping[j]),
                klim=float(g.limit_strength[j]), kang=float(g.angular_damping[j]),
                act_idx=int(g.act_idx[j]), act_k=float(g.act_strength[j]),
                act_kind=int(g.act_kind[j])))
    return joints


def _host_constants(sys):
    n = sys.num_bodies
    default_rot = [tuple(float(v) for v in sys._default_pose[1][i]) for i in range(n)]
    inv_mass = [float(m) for m in sys.body.inv_mass]
    inv_inertia = [tuple(float(v) for v in row) for row in sys.body.inv_inertia]
    return default_rot, inv_mass, inv_inertia


def test_step_tables_equal_fused(pair):
    jsys, tsys = pair
    assert_same(_fused_joint_table(jsys), step_tables.joint_table(tsys), "joints")
    jconst, tconst = _host_constants(jsys), _host_constants(tsys)
    assert_same(jconst, tconst, "constants")
    cb_j = step_tables.contact_rows(jsys.contacts.capsule_box, step_tables.CB_FIELDS)
    cb_t = step_tables.contact_rows(tsys.contacts.capsule_box, step_tables.CB_FIELDS)
    pp_j = step_tables.contact_rows(jsys.contacts.point_plane, step_tables.PP_FIELDS)
    pp_t = step_tables.contact_rows(tsys.contacts.point_plane, step_tables.PP_FIELDS)
    assert (len(cb_t), len(pp_t)) == (36, 9)
    assert_same(fused._compile_cb_vec(cb_j, *jconst),
                step_tables.compile_cb_vec(cb_t, *tconst), "cb_vec")
    assert_same(fused._compile_pp_vec(pp_j, *jconst),
                step_tables.compile_pp_vec(pp_t, *tconst), "pp_vec")


def test_packed_tables_layout(pair):
    _, tsys = pair
    t = step_tables.build(tsys)
    buf = step_tables.pack(t)
    want = (step_tables.words(step_tables.HEADER) + 12 * step_tables.words(step_tables.BODY)
            + 8 * step_tables.words(step_tables.JOINT)
            + 9 * step_tables.words(step_tables.POINT_PLANE)
            + 36 * step_tables.words(step_tables.CAPSULE_BOX))
    assert buf.dtype == np.float32 and buf.size == want
    header = buf[:step_tables.words(step_tables.HEADER)].view(np.int32)
    assert list(header[:6]) == [12, 8, 10, 8, 9, 36]


def _uncovered(kind):
    """Scenes with one feature the whole-step kernel does not cover yet."""
    c = tc
    ball = c.Body(name="ball", colliders=(c.Collider(geom=c.Sphere(0.2)),))
    rod = c.Body(name="rod", colliders=(c.Collider(geom=c.Capsule(radius=0.1, length=0.6)),))
    box = c.Body(name="box", colliders=(c.Collider(geom=c.Box(halfsize=(0.3, 0.3, 0.3))),))
    hinge = dict(name="j", parent="ball", child="rod", child_offset=(0.0, 0.0, 0.3))
    base = c.Config(bodies=(ball, rod), joints=(c.Joint(**hinge),),
                    actuators=(c.Actuator(name="j", joint="j", strength=10.0),))
    if kind == "mini":
        return mini_cfg(c)
    if kind == "thruster":
        return base.evolve(thrusters=(c.Thruster(name="t", body="ball", strength=1.0),))
    if kind == "sphere_sphere":
        return base.evolve(bodies=(ball, rod, dataclasses.replace(ball, name="b2")),
                           collide_include=(("ball", "b2"),))
    if kind == "capsule_capsule":
        return base.evolve(bodies=(ball, rod, dataclasses.replace(rod, name="r2")),
                           collide_include=(("rod", "r2"),))
    if kind == "moving_box":
        return base.evolve(bodies=(ball, rod, box), collide_include=(("rod", "box"),))
    if kind == "two_dof":
        j2 = c.Joint(**hinge, angle_limits=(c.AngleLimit(-30, 30), c.AngleLimit(-20, 20)))
        return base.evolve(joints=(j2,))
    if kind == "angle_servo":
        return base.evolve(actuators=(c.Actuator(name="j", joint="j", strength=10.0,
                                                 kind="angle"),))
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["mini", "thruster", "sphere_sphere", "capsule_capsule",
                                  "moving_box", "two_dof", "angle_servo"])
def test_step_tables_reject_uncovered_features(kind):
    sys_ = TSystem(_uncovered(kind), device="cpu")
    with pytest.raises(ValueError, match="whole-step kernel"):
        step_tables.build(sys_)
