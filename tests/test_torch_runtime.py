"""The port's runtime layer (`mpcc_manipulator_tpu_torch/runtime/`) against
the JAX package's (`mpcc_manipulator_tpu/runtime/`), on the CPU:

* `track_gen`: the Lissajous and the DYROS letter tracks identical, value
  for value, to JAX's (the same numpy and font); the written JSON loads
  through the port's `splines.arc_length.load_track_waypoints`;
* `native`: the five tests of `tests/test_native_runtime.py` on the port's
  build (``build/native/``, never ``cpp/``), and the telemetry files
  byte-identical to the JAX package's for the same records;
* `checkpoint`: the three tests of `tests/test_checkpoint.py:52-97` on the
  port's `mpc_step` (float32, plain versions), and checkpoints crossing
  between the packages in float64: a state JAX saved restores into the
  port, whose next 3 ticks match JAX's own resumed ticks to 1e-12, and a
  state the port saved restores into JAX's template.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.runtime import checkpoint as jckpt
from mpcc_manipulator_tpu.runtime import native as jnative
from mpcc_manipulator_tpu.runtime import track_gen as jtrack_gen
from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
from mpcc_manipulator_tpu_torch.models import dynamics as dyn
from mpcc_manipulator_tpu_torch.models import kinematics as kin
from mpcc_manipulator_tpu_torch.mpc import MPCCarry, init_carry, mpc_step
from mpcc_manipulator_tpu_torch.params import SQPConfig, load_params
from mpcc_manipulator_tpu_torch.problem import X0_HOME
from mpcc_manipulator_tpu_torch.runtime import checkpoint as ckpt
from mpcc_manipulator_tpu_torch.runtime import native, track_gen
from mpcc_manipulator_tpu_torch.splines import arc_length as als

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ track_gen


def test_lissajous_track_identical_to_jax():
    assert track_gen.lissajous_track() == jtrack_gen.lissajous_track()


def test_letter_track_identical_to_jax():
    got = track_gen.letter_track("DYROS", height=0.10, n_points=300)
    ref = jtrack_gen.letter_track("DYROS", height=0.10, n_points=300)
    assert got == ref
    assert len(got["Y"]) > 250


def test_written_track_loads(tmp_path):
    """write_track -> the port's load_track_waypoints: the waypoints as
    written, the flipped-down orientation (quat (1, 0, 0, 0))."""
    trk = track_gen.letter_track("DYROS", height=0.10, n_points=300)
    path = str(tmp_path / "dyros.json")
    track_gen.write_track(path, trk)
    with open(path) as f:
        assert json.load(f) == trk
    x, y, z, rots = als.load_track_waypoints(path)
    np.testing.assert_array_equal(x, trk["X"])
    np.testing.assert_array_equal(y, trk["Y"])
    np.testing.assert_array_equal(z, trk["Z"])
    np.testing.assert_allclose(rots, np.tile(np.diag([1.0, -1.0, -1.0]),
                                             (len(x), 1, 1)), atol=1e-15)
    track_gen.write_track(path)             # default: the Lissajous figure
    with open(path) as f:
        assert json.load(f) == track_gen.lissajous_track()


# ------------------------------------------------------------ native


def test_parse_floats_matches_numpy(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((50, 21))
    f = tmp_path / "w.txt"
    np.savetxt(f, data)
    parsed = native.parse_floats(str(f))
    assert np.allclose(parsed, data.reshape(-1), atol=1e-12)


def test_parse_reference_weight_file(tmp_path):
    """A weight file in the reference's text layout (the repo's
    self-collision layer 0, 256 x 21, one row a line) parses to
    numpy.loadtxt's values."""
    w = np.load(os.path.join(_REPO, "assets", "nn", "self.npz"))["weight_0"]
    path = str(tmp_path / "weight_0.txt")
    np.savetxt(path, w)
    parsed = native.parse_floats(path)
    ref = np.loadtxt(path).reshape(-1)
    assert parsed.size == ref.size == 256 * 21
    assert np.allclose(parsed, ref)


def test_telemetry_ring_binary(tmp_path):
    f = tmp_path / "log.bin"
    rl = 5
    with native.TelemetryRing(str(f), rl, capacity=64) as ring:
        for i in range(20):
            ring.append(np.arange(rl, dtype=np.float64) + i)
        assert ring.dropped == 0
    data = np.fromfile(f, dtype=np.float64).reshape(-1, rl)
    assert data.shape == (20, rl)
    assert np.allclose(data[7], np.arange(rl) + 7)


def test_telemetry_ring_text(tmp_path):
    f = tmp_path / "debug.txt"
    with native.TelemetryRing(str(f), 3, capacity=16, text_mode=True) as ring:
        ring.append(np.array([1.5, -2.25, 3.0]))
        ring.append(np.array([4.0, 5.0, 6.0]))
    rows = np.loadtxt(f)
    assert rows.shape == (2, 3)
    assert np.allclose(rows[0], [1.5, -2.25, 3.0])


def test_native_available_or_fallback():
    # either path must work; report which one is active
    assert native.parse_floats.__doc__ is not None
    print("native available:", native.native_available())


def test_native_fallback_only_without_a_compiler(tmp_path, monkeypatch):
    """No C++ compiler: the Python fallback runs.  A source that does not
    compile raises with the compiler's messages, never falls back."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.delenv("CXX", raising=False)
    with monkeypatch.context() as m:
        m.setattr(native.shutil, "which", lambda name: None)
        with pytest.raises(native.NoCompiler):
            native.build()
        assert not native.native_available()
        assert native.parse_floats.__doc__ is not None
    if shutil.which("g++") is None and shutil.which("c++") is None:
        return
    broken = tmp_path / "broken.cpp"
    broken.write_text("int f( {\n")
    monkeypatch.setattr(native, "_SRC", str(broken))
    monkeypatch.setattr(native, "_build_failed", False)
    with pytest.raises(RuntimeError, match="error") as err:
        native.native_available()
    assert not isinstance(err.value, native.NoCompiler)


def test_native_builds_into_build_dir_not_cpp():
    """The library builds from the port's own copy of the source into
    ``build/native/`` under a source-hash name; the JAX package's ``cpp/``
    gains nothing."""
    before = sorted(os.listdir(os.path.join(_REPO, "cpp")))
    if native.native_available():
        path = native.library_path()
        assert os.path.exists(path)
        assert os.path.dirname(path) == native.BUILD_DIR
        assert native.BUILD_DIR == os.path.join(_REPO, "build", "native")
    assert sorted(os.listdir(os.path.join(_REPO, "cpp"))) == before


@pytest.mark.parametrize("text_mode", [False, True], ids=["binary", "text"])
def test_telemetry_files_identical_to_jax(tmp_path, text_mode):
    """The same records through the port's ring and JAX's give the same
    file, byte for byte (20 records of 22 doubles, the demo's debug
    record)."""
    rng = np.random.default_rng(5)
    recs = rng.standard_normal((20, 22)) * 10.0 ** rng.integers(-6, 4, 22)
    paths = []
    for mod, name in ((native, "port"), (jnative, "jax")):
        p = str(tmp_path / f"{name}.log")
        with mod.TelemetryRing(p, 22, capacity=64,
                               text_mode=text_mode) as ring:
            for r in recs:
                ring.append(r)
        paths.append(p)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        got, ref = a.read(), b.read()
    assert len(got) > 0 and got == ref


# ------------------------------------------------------------ checkpoint

TS = 0.01
# tests/test_checkpoint.py's `SQPConfig(max_iter=2, qp_solver="riccati",
# ipm_max_iter=6)` on the port's structured route
CKPT_CFG = SQPConfig(rti=False, max_iter=2, ipm_max_iter=6)


@pytest.fixture(scope="module")
def setup32():
    dt, dev = torch.float32, "cpu"
    params, _ = load_params(dtype=dt, device=dev)
    sel_nn = cnn.load_self_collision_nn(dt, dev)
    env_nn = cnn.load_env_collision_nn(dt, dev)
    q0 = torch.tensor(X0_HOME[:7])
    ee, rot = kin.ee_position(q0).numpy(), kin.ee_orientation(q0).numpy()
    phi = np.linspace(0, 2 * np.pi, 40)
    track = als.gen_6d_spline(
        np.zeros(40) + ee[0], 0.15 * np.cos(phi) - 0.15 + ee[1],
        0.15 * np.sin(phi) + ee[2], np.tile(rot, (40, 1, 1)), dt, dev)
    x0 = torch.tensor(X0_HOME[None], dtype=dt)
    return params, sel_nn, env_nn, track, x0


def _tick(setup, state):
    params, sel_nn, env_nn, track, _ = setup
    carry, x, u = state
    dt = x.dtype
    obs = torch.tensor([[3.0, 3.0, 3.0]], dtype=dt)
    carry, out = mpc_step(track, params, sel_nn, env_nn, carry, x, u, obs,
                          torch.zeros(1, dtype=dt), ts=TS, cfg=CKPT_CFG)
    return (carry, dyn.sim_time_step(out.x0_updated, out.u0, TS), out.u0)


def _state(dtype, x0):
    return (init_carry(1, dtype, "cpu"), x0.to(dtype),
            torch.zeros(1, 8, dtype=dtype))


def test_resume_is_bit_identical(setup32, tmp_path):
    x0 = setup32[-1]
    ref = _state(torch.float32, x0)
    for _ in range(6):
        ref = _tick(setup32, ref)
    st = _state(torch.float32, x0)
    for _ in range(3):
        st = _tick(setup32, st)
    path = str(tmp_path / "ckpt_3.npz")
    ckpt.save_state(path, st, step=3)
    st2, step = ckpt.restore_state(path, _state(torch.float32, x0))
    assert step == 3
    assert isinstance(st2[0], MPCCarry)
    for _ in range(3):
        st2 = _tick(setup32, st2)
    for a, b in zip((ref[1], ref[2]), (st2[1], st2[2])):
        assert torch.equal(a, b)


def test_latest_and_mismatch(setup32, tmp_path):
    x0 = setup32[-1]
    state = _state(torch.float32, x0)
    ckpt.save_state(str(tmp_path / "ckpt_1.npz"), state, step=1)
    ckpt.save_state(str(tmp_path / "ckpt_10.npz"), state, step=10)
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("ckpt_10.npz")
    assert ckpt.latest_checkpoint(str(tmp_path / "nope")) is None
    # wrong template structure fails loudly
    with pytest.raises(ValueError):
        ckpt.restore_state(str(tmp_path / "ckpt_1.npz"), (x0,))
    # wrong leaf shape fails loudly
    bad = (init_carry(1, torch.float32, "cpu"), torch.zeros(1, 10),
           torch.zeros(1, 8))
    with pytest.raises(ValueError):
        ckpt.restore_state(str(tmp_path / "ckpt_1.npz"), bad)


def test_dtype_mismatch_refused_widening_allowed(setup32, tmp_path):
    """A float64 checkpoint must not silently truncate into a float32
    template; the value-preserving direction stays allowed."""
    x0 = setup32[-1]
    state64 = _state(torch.float64, x0)
    ckpt.save_state(str(tmp_path / "c64.npz"), state64, step=3)
    tmpl32 = _state(torch.float32, x0)
    with pytest.raises(ValueError, match="dtype"):
        ckpt.restore_state(str(tmp_path / "c64.npz"), tmpl32)
    ckpt.save_state(str(tmp_path / "c32.npz"), tmpl32, step=4)
    restored, step = ckpt.restore_state(str(tmp_path / "c32.npz"), state64)
    assert step == 4
    assert restored[1].dtype == torch.float64
    assert restored[0].z_guess.dtype == torch.float64


# -- across the packages (float64; JAX batched with vmap so both states
# carry the scenario axis)

CROSS_LANES = 2
CROSS_TOL = 1e-12


@pytest.fixture(scope="module")
def cross():
    from __graft_entry__ import _build_problem
    from mpcc_manipulator_tpu.models import dynamics as jdyn
    from mpcc_manipulator_tpu.mpc import init_carry as j_init_carry
    from mpcc_manipulator_tpu.mpc import mpc_step as j_mpc_step
    from mpcc_manipulator_tpu.params import SQPConfig as JaxSQPConfig
    from mpcc_manipulator_tpu_torch import convert
    track, params, _, sel_nn, env_nn, _, _, _, obs = _build_problem(
        jnp.float64, small=False)
    jcfg = JaxSQPConfig(max_iter=1, rti=True, qp_solver="riccati_struct",
                        kin_backend="xla", mani_grad="analytic",
                        ipm_warm_start=True, ipm_max_iter=25)

    def one(c, x, u):
        c, o = j_mpc_step(track, params, sel_nn, env_nn, c, x, u, obs,
                          jnp.asarray(0.0, jnp.float64), ts=TS, cfg=jcfg)
        return c, jdyn.sim_time_step(o.x0_updated, o.u0, TS), o.u0

    jstep = jax.jit(jax.vmap(one))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    port = (convert.track(np_tree(track), device="cpu"),
            convert.mpcc_params(np_tree(params), device="cpu"),
            convert.mlp(np_tree(sel_nn), device="cpu"),
            convert.mlp(np_tree(env_nn), device="cpu"))
    rng = np.random.default_rng(3)
    x0 = np.tile(X0_HOME, (CROSS_LANES, 1))
    x0[1:, :7] += 1e-3 * rng.standard_normal((CROSS_LANES - 1, 7))
    jtemplate = lambda: (
        jax.vmap(lambda _: j_init_carry(jnp.float64))(jnp.arange(CROSS_LANES)),
        jnp.asarray(x0), jnp.zeros((CROSS_LANES, 8), jnp.float64))
    return jstep, jtemplate, port, x0, np.asarray(obs)


def _port_tick(port, state, obs):
    track, params, sel, env = port
    carry, x, u = state
    b = x.shape[0]
    carry, out = mpc_step(track, params, sel, env, carry, x, u,
                          torch.tensor(obs).expand(b, 3),
                          torch.zeros(b, dtype=torch.float64), ts=TS,
                          cfg=SQPConfig())
    return (carry, dyn.sim_time_step(out.x0_updated, out.u0, TS), out.u0)


def _port_template(x0):
    return (init_carry(CROSS_LANES, torch.float64, "cpu"),
            torch.tensor(x0), torch.zeros(CROSS_LANES, 8, dtype=torch.float64))


def test_jax_checkpoint_resumes_in_the_port(cross, tmp_path):
    """JAX runs 6 ticks and saves; its own 3 resumed ticks against the
    port's 3 ticks from the same file: states and inputs within 1e-12."""
    jstep, jtemplate, port, x0, obs = cross
    st = jtemplate()
    for _ in range(6):
        st = jstep(*st)
    path = str(tmp_path / "ckpt_6.npz")
    jckpt.save_state(path, st, step=6)
    jst, step = jckpt.restore_state(path, jtemplate())
    pst, pstep = ckpt.restore_state(path, _port_template(x0))
    assert step == pstep == 6
    assert bool(pst[0].valid_guess.all())
    for _ in range(3):
        jst = jstep(*jst)
        pst = _port_tick(port, pst, obs)
        for a, b in ((pst[1], jst[1]), (pst[2], jst[2]),
                     (pst[0].z_guess, jst[0].z_guess)):
            gap = float(np.abs(a.numpy() - np.asarray(b)).max())
            assert gap < CROSS_TOL, gap


def test_port_checkpoint_restores_into_jax(cross, tmp_path):
    """The port runs 6 ticks and saves; JAX's template takes the file, every
    leaf equal to the port's state, bit for bit."""
    _, jtemplate, port, x0, obs = cross
    st = _port_template(x0)
    for _ in range(6):
        st = _port_tick(port, st, obs)
    path = str(tmp_path / "ckpt_6.npz")
    ckpt.save_state(path, st, step=6)
    jst, step = jckpt.restore_state(path, jtemplate())
    assert step == 6
    got = jax.tree_util.tree_leaves(jst)
    ref = [leaf for _, leaf in ckpt._flatten_with_names(st)]
    assert len(got) == len(ref) == 9
    for g, r in zip(got, ref):
        g = np.asarray(g)
        assert g.dtype == r.numpy().dtype
        np.testing.assert_array_equal(g, r.numpy())
