"""Every example under examples/ must run green (each asserts its own
outcome internally); distributed_fleet.py runs through the launcher's
spawn mode like its docstring says."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")

DIRECT = [f for f in sorted(os.listdir(EXAMPLES))
          if f.endswith(".py") and f != "distributed_fleet.py"]


def _run(argv, timeout=420):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)       # examples set their own device count
    env["PYTHONPATH"] = REPO
    p = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, f"{argv}:\n{p.stdout}\n{p.stderr}"
    return p.stdout


@pytest.mark.slow
@pytest.mark.parametrize("name", DIRECT)
def test_example_runs(name):
    _run([os.path.join(EXAMPLES, name)])


@pytest.mark.slow
def test_distributed_fleet_example_via_launcher():
    out = _run(["-m", "pyipm_jax.parallel.launch", "--spawn", "2",
                os.path.join(EXAMPLES, "distributed_fleet.py")])
    assert "converged" in out
