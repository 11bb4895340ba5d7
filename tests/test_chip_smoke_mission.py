"""chip_smoke.py's mission and multi-device phases at tiny sizes on the CPU.

Kept apart from test_chip_smoke.py so the two files' compiles run on
separate test workers."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TINY_MISSION = dict(plan_iters=6, e_max=6, max_nodes=16, samples_per_edge=6)


def test_phase_mission_tiny():
    argv = cs.MISSION_ARGV + ["--budget", "20", "--bd", "2",
                              "--plan-iters", "6", "--e-max", "6"]
    out = cs.phase_mission(argv, log=lambda s: None)
    assert out["n_replans"] >= 1


def test_phase_mesh_tiny():
    out = cs.phase_mesh(4, n_train=48, plan_iters=8, log=lambda s: None,
                        mission_kw=dict(B=20.0, BD=2, mission=TINY_MISSION))
    assert out["plan_err"] <= cs.TOL_MESH
    assert out["mission_err"] <= cs.TOL_MESH_F64
