"""CPU tests of chip_smoke.py: the device check refuses a CPU-only host,
phase 3's comparison helpers hold at small grids with both sides on the
CPU backend, the main path imports without sympy, and the compile cache
goes where the package says."""

import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _python(code, env_extra=(), unset=()):
    env = dict(os.environ, **dict(env_extra))
    for k in unset:
        env.pop(k, None)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO, env=env)


def test_device_check_exits_nonzero_on_cpu():
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not a GPU" in r.stderr


def _cpu():
    return jax.local_devices(backend="cpu")[0]


@pytest.mark.parametrize("case", ["latlon", "lon", "dp_oracles", "idm",
                                  "batched_mpc", "poly_sampling_pinned"])
def test_phase3_helpers_on_cpu(case):
    cpu = _cpu()
    if case == "latlon":
        out = cs.compare_latlon(
            dict(t_steps=10, s_steps=41, ds_steps=9, l_steps=7), cpu, cpu)
        assert out["decision_diff_cells"] == 0
        assert out["s_end"] > 10.0
    elif case == "lon":
        out = cs.compare_lon(dict(t_steps=6, s_steps=41, v_steps=9,
                                  a_steps=5, path_steps=50), cpu, cpu)
        assert out["constr_diff_cells"] == 0
        assert out["constr_tie_cells"] == 0
    elif case == "dp_oracles":
        out = cs.compare_dp_oracles(cpu)
        assert out["latlon_grid"] == list(cs.LATLON_ORACLE_SPEC.values())
    elif case == "idm":
        out = cs.compare_idm(64, 16, cpu, cpu)
        assert out["compared"] == 16 and not out["argmin_tie"]
    elif case == "batched_mpc":
        # f32 lanes engine against the f64 per-instance solve: the
        # tolerances phase 3 states hold on the CPU backend too
        out = cs.compare_mpc(32, 60, 4, cpu, cpu)
        assert out["max_u0_diff"] < cs.MPC_U0_ATOL
    else:
        out = cs.compare_poly_sampling(calls=3)
        assert out["max_pos_diff_m"] == 0.0


@pytest.mark.parametrize("finished,emergency,violations,ok", [
    (True, 0, [], True),
    (False, 0, [], False),          # stalled: the scene never finished
    (True, 3, [], False),
    (True, 0, ["collision"], False),
])
def test_check_loop(finished, emergency, violations, ok):
    rec = dict(ticks=2001, sim_t=20.0 if finished else 60.0,
               finished=finished, violations=violations,
               emergency_ticks=emergency, ego_x=114.9, ego_v=0.0)
    if ok:
        cs.check_loop(rec, "planner")
    else:
        with pytest.raises(AssertionError):
            cs.check_loop(rec, "planner")


def test_main_path_imports_without_sympy():
    r = _python("import sys; sys.modules['sympy'] = None\n"
                "import tpl_tpu.simulation, tpl_tpu.optim, tpl_tpu.planning\n"
                "print('ok')", {"JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


@pytest.mark.parametrize("from_env", [False, True])
def test_compile_cache_dir(from_env, tmp_path):
    code = ("import json, jax, tpl_tpu\n"
            "print(json.dumps(jax.config.jax_compilation_cache_dir))")
    if from_env:
        want = str(tmp_path / "jax_cache")
        r = _python(code, {"JAX_PLATFORMS": "cpu",
                           "JAX_COMPILATION_CACHE_DIR": want})
    else:
        want = os.path.join(REPO, ".cache", "jax")
        r = _python(code, {"JAX_PLATFORMS": "cpu"},
                    unset=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == want
