"""Multi-process launcher — the process-launcher/elastic-agent analog.

The reference has no launcher or multi-process story at all (SURVEY.md §2
absence table: "Process launcher / elastic agent — No"); the equivalent
here is one process per host (or per GPU) joined through
``jax.distributed``.
This module is that launcher:

  * **Cluster mode** (one command per host, e.g. under SLURM/GKE/ssh)::

        python -m pyipm_jax.parallel.launch \
            --coordinator host0:8476 --num-processes 4 --process-id $I \
            script.py [args...]

    sets the ``PYIPM_*`` rendezvous variables and execs ``script.py`` in
    THIS process; the script's ``distributed.initialize()`` picks them up.

  * **Local spawn mode** (testing / CPU clusters on one box)::

        python -m pyipm_jax.parallel.launch --spawn 2 script.py [args...]

    forks N copies of ``script.py`` on localhost with a free coordinator
    port, each exposing ``--local-devices`` virtual CPU devices
    (``spawn_local(..., cpu=False)``: worker i sees GPU i alone), streams
    their output, and **fails fast**: the first worker to die takes the
    whole job down (remaining workers are killed by exact PID — a hung
    collective would otherwise block forever).  This is the standard way
    to exercise the multi-host code path without a cluster.

Failure handling is fail-fast + resume, not in-place elasticity: JAX
collectives are compiled for a fixed topology, so a lost process cannot
be replaced mid-run.  The launcher's exit code says WHICH worker failed;
recovery is relaunching the same world size from the last checkpoint
(``utils/checkpoint`` serializes the SolverState pytree; the solver
resumes bit-exactly from it — core/solver.py pause/resume contract).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from typing import Mapping, Optional, Sequence

# Rendezvous environment contract consumed by distributed.initialize()
ENV_COORD = "PYIPM_COORDINATOR"
ENV_NPROC = "PYIPM_NUM_PROCESSES"
ENV_PROC_ID = "PYIPM_PROCESS_ID"
ENV_LOCAL_DEVICES = "PYIPM_LOCAL_DEVICES"


def _set_device_count_flag(flags: str, n: int) -> str:
    """Set --xla_force_host_platform_device_count=n in an XLA_FLAGS string,
    REPLACING any existing value (an inherited test-env flag would otherwise
    silently win over the launcher's --local-devices)."""
    import re
    pat = r"--xla_force_host_platform_device_count=\d+"
    new = f"--xla_force_host_platform_device_count={n}"
    if re.search(pat, flags):
        return re.sub(pat, new, flags)
    return (flags + " " + new).strip()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rendezvous_env(coordinator: str, num_processes: int, process_id: int,
                   local_devices: Optional[int] = None) -> dict:
    """The environment block a worker needs to join the cluster."""
    env = {
        ENV_COORD: coordinator,
        ENV_NPROC: str(num_processes),
        ENV_PROC_ID: str(process_id),
    }
    if local_devices is not None:
        env[ENV_LOCAL_DEVICES] = str(local_devices)
    return env


def gpu_count() -> int:
    """GPUs ``nvidia-smi`` lists on this machine; 0 where it is absent."""
    try:
        out = subprocess.run(["nvidia-smi", "--list-gpus"],
                             capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return 0
    return sum(ln.startswith("GPU ") for ln in out.stdout.splitlines())


def worker_env(base: Mapping[str, str], coordinator: str,
               num_processes: int, process_id: int, *, local_devices: int,
               cpu: bool) -> dict:
    """Environment of local worker ``process_id``: the rendezvous block,
    plus either ``local_devices`` virtual CPU devices (``cpu=True``) or
    GPU ``process_id`` alone — a JAX process reserves most of every card
    it can see at start-up, so two processes must not see one card."""
    env = dict(base)
    if cpu:
        env.update(rendezvous_env(coordinator, num_processes, process_id,
                                  local_devices))
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = _set_device_count_flag(
            env.get("XLA_FLAGS", ""), local_devices)
    else:
        env.update(rendezvous_env(coordinator, num_processes, process_id))
        env["CUDA_VISIBLE_DEVICES"] = str(process_id)
    return env


def spawn_local(num_processes: int, argv: Sequence[str], *,
                local_devices: int = 4, cpu: bool = True,
                timeout: Optional[float] = None) -> int:
    """Spawn ``num_processes`` copies of ``argv`` on localhost and wait.

    Returns 0 iff every worker exited 0.  On the first failure the
    remaining workers are terminated by PID and the failing worker's exit
    code is returned.  ``cpu=True`` forces each worker onto
    ``local_devices`` virtual CPU devices (the hermetic test topology);
    ``cpu=False`` gives worker i GPU i and refuses more workers than
    GPUs.
    """
    if not cpu and num_processes > gpu_count():
        raise ValueError(f"{num_processes} GPU workers need as many GPUs; "
                         f"this machine has {gpu_count()}")
    coord = f"localhost:{_free_port()}"
    procs = []
    for i in range(num_processes):
        env = worker_env(os.environ, coord, num_processes, i,
                         local_devices=local_devices, cpu=cpu)
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=env,
            stdout=None if i == 0 else subprocess.DEVNULL,
            stderr=None))
    import time as _time

    code = 0
    timed_out = False
    deadline = None if timeout is None else _time.monotonic() + timeout
    try:
        # poll ALL workers round-robin: the first nonzero exit fails the
        # job immediately (a worker that dies during rendezvous would
        # otherwise leave the rest blocked in a collective forever)
        live = list(procs)
        while live and code == 0:
            for p in list(live):
                rc = p.poll()
                if rc is None:
                    continue
                live.remove(p)
                if rc != 0:
                    code = rc
                    break
            if deadline is not None and _time.monotonic() > deadline:
                code = 124
                timed_out = True
            _time.sleep(0.05)
    finally:
        for p in procs:       # exact PIDs we started — never by pattern
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if timed_out:
        # workers were killed in the finally block (returncode -9); deriving
        # a failed list from those would misattribute the timeout to them
        print(f"[launch] FAILED: timed out after {timeout}s; workers "
              f"terminated (exit {code})", file=sys.stderr)
    elif code != 0:
        failed = [i for i, p in enumerate(procs) if p.returncode not in (0, None)]
        print(f"[launch] FAILED: worker(s) {failed} exited nonzero; "
              f"job terminated (exit {code})", file=sys.stderr)
    return code


def main(args: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pyipm_jax.parallel.launch",
        description="Launch a pyipm_jax program across processes/hosts.")
    ap.add_argument("--spawn", type=int, metavar="N",
                    help="local mode: fork N workers on this machine")
    ap.add_argument("--local-devices", type=int, default=4,
                    help="virtual CPU devices per spawned worker "
                         "(local mode; default 4)")
    ap.add_argument("--coordinator", metavar="HOST:PORT",
                    help="cluster mode: rendezvous address (host 0)")
    ap.add_argument("--num-processes", type=int,
                    help="cluster mode: total process count")
    ap.add_argument("--process-id", type=int,
                    help="cluster mode: this host's rank")
    ap.add_argument("--timeout", type=float, default=None,
                    help="local mode: per-worker wall clock limit (s)")
    ap.add_argument("script", help="python script to run")
    ap.add_argument("script_args", nargs=argparse.REMAINDER,
                    help="arguments forwarded to the script")
    ns = ap.parse_args(args)

    if ns.spawn is not None:
        if ns.coordinator or ns.num_processes or ns.process_id is not None:
            ap.error("--spawn is exclusive with cluster-mode flags")
        return spawn_local(ns.spawn, [ns.script, *ns.script_args],
                           local_devices=ns.local_devices,
                           timeout=ns.timeout)

    if (ns.coordinator is None) or (ns.num_processes is None) \
            or (ns.process_id is None):
        ap.error("cluster mode needs --coordinator, --num-processes and "
                 "--process-id (or use --spawn N)")
    os.environ.update(rendezvous_env(
        ns.coordinator, ns.num_processes, ns.process_id))
    # exec the script in-process so its distributed.initialize() sees the
    # rendezvous env and jax is initialized exactly once
    sys.argv = [ns.script, *ns.script_args]
    with open(ns.script) as f:
        code = compile(f.read(), ns.script, "exec")
    g = {"__name__": "__main__", "__file__": ns.script}
    exec(code, g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
