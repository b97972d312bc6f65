"""Launcher tests (SURVEY.md §2 "process launcher / elastic agent" row —
absent in the reference; parallel/launch.py is the equivalent here).

Covers local spawn mode end-to-end (2 workers forming a real
jax.distributed cluster via the PYIPM_* rendezvous env), the fail-fast
contract (one dead worker takes the job down with its exit code instead
of hanging the rendezvous), and CLI argument validation.
"""

import os
import subprocess
import sys

import pytest

from pyipm_jax.parallel.launch import main as launch_main, spawn_local

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "launch_worker.py")


def _spawn(extra=(), **kw):
    # spawn_local REPLACES any inherited device-count flag (conftest forces
    # 8 virtual devices into XLA_FLAGS; workers must see local_devices=2)
    os.environ["PYTHONPATH"] = REPO   # inherited by spawn_local children
    return spawn_local(2, [WORKER, *extra], local_devices=2,
                       timeout=300, **kw)


@pytest.mark.slow
def test_spawn_local_two_workers():
    assert _spawn() == 0


@pytest.mark.slow
def test_spawn_local_fail_fast():
    # rank 1 exits 3 before joining; the job must fail with that code
    # promptly instead of deadlocking rank 0's rendezvous
    assert _spawn(extra=["--fail-rank", "1"]) == 3


def test_cli_validation():
    with pytest.raises(SystemExit):
        launch_main(["--spawn", "2", "--coordinator", "x:1", "w.py"])
    with pytest.raises(SystemExit):
        launch_main(["--coordinator", "x:1", "w.py"])   # missing rank/size


@pytest.fixture
def _clean_rendezvous_env():
    """cluster-mode main() writes PYIPM_* into this process's environ; a
    leak would make any later in-process distributed.initialize() try to
    join the fake coordinator."""
    from pyipm_jax.parallel import launch as L

    keys = (L.ENV_COORD, L.ENV_NPROC, L.ENV_PROC_ID, L.ENV_LOCAL_DEVICES)
    saved = {k: os.environ.get(k) for k in keys}
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_cluster_mode_sets_env_and_execs(tmp_path, _clean_rendezvous_env):
    script = tmp_path / "probe.py"
    script.write_text(
        "import os, sys\n"
        "from pyipm_jax.parallel.launch import ENV_COORD, ENV_NPROC, "
        "ENV_PROC_ID\n"
        "assert os.environ[ENV_COORD] == 'h:1234'\n"
        "assert os.environ[ENV_NPROC] == '4'\n"
        "assert os.environ[ENV_PROC_ID] == '2'\n"
        "assert sys.argv[1:] == ['--flag', 'v']\n"
        "open(os.environ['PROBE_OUT'], 'w').write('ran')\n")
    out = tmp_path / "out.txt"
    os.environ["PROBE_OUT"] = str(out)
    try:
        rc = launch_main([
            "--coordinator", "h:1234", "--num-processes", "4",
            "--process-id", "2", str(script), "--flag", "v"])
    finally:
        del os.environ["PROBE_OUT"]
    assert rc == 0
    assert out.read_text() == "ran"


def test_worker_env_gpu_one_card_each():
    """GPU workers each see exactly one card, named by their rank, and no
    virtual-CPU flags; CPU workers get the forced device count."""
    from pyipm_jax.parallel import launch as L

    base = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
            "CUDA_VISIBLE_DEVICES": "0,1,2,3"}
    envs = [L.worker_env(base, "localhost:1", 4, i, local_devices=2,
                         cpu=False) for i in range(4)]
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "2", "3"]
    for i, e in enumerate(envs):
        assert e[L.ENV_PROC_ID] == str(i) and e[L.ENV_NPROC] == "4"
        assert L.ENV_LOCAL_DEVICES not in e and "JAX_PLATFORMS" not in e
    cpu = L.worker_env(base, "localhost:1", 2, 1, local_devices=2, cpu=True)
    assert cpu["JAX_PLATFORMS"] == "cpu"
    assert cpu["XLA_FLAGS"] == "--xla_force_host_platform_device_count=2"
    assert cpu[L.ENV_LOCAL_DEVICES] == "2"


def test_spawn_gpu_refuses_more_workers_than_cards(monkeypatch):
    from pyipm_jax.parallel import launch as L

    monkeypatch.setattr(L, "gpu_count", lambda: 2)
    with pytest.raises(ValueError, match="need as many GPUs"):
        L.spawn_local(3, ["unused.py"], cpu=False)
