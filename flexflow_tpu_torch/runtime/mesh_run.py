"""Launch local ranks of a process group, and the rank program they run.

`launch(nprocs, [target, *args], out_dir)` starts `nprocs` local
processes of `python -m flexflow_tpu_torch.runtime.mesh_run target
*args` under the port's env contract (FF_COORDINATOR_ADDRESS on a free
localhost port, FF_NUM_PROCESSES, FF_PROCESS_ID; runtime/distributed.py),
waits for all of them within `timeout` seconds, kills every rank on
expiry and raises. Each rank's output goes to `<out_dir>/rank<r>.log`.

The rank program (`main`, `[--device D] target *args`) joins the group
(`--device cpu`: gloo, else NCCL on the rank's card), loads `target` (a
path to a Python file) and calls its `run(rank, world, device, args)`,
whose return value is the rank's exit code, then leaves the group. The ranks start with the repository root on PYTHONPATH.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(nprocs: int, args: Sequence[str], out_dir: str, *,
           timeout: float = 150.0, env: Optional[dict] = None) -> List[int]:
    """Run `nprocs` ranks of the rank program with `args` (the target
    first) and return their exit codes. Every rank is killed once
    `timeout` seconds pass, and then TimeoutError names the ranks still
    running (their logs are in `out_dir`)."""
    os.makedirs(out_dir, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = dict(os.environ)
    base.update(env or {})
    base.update(
        FF_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
        FF_NUM_PROCESSES=str(nprocs), OMP_NUM_THREADS="1",
        PYTHONPATH=root + os.pathsep + base.get("PYTHONPATH", ""))
    procs, logs = [], []
    try:
        for r in range(nprocs):
            log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "flexflow_tpu_torch.runtime.mesh_run",
                 *args], env=dict(base, FF_PROCESS_ID=str(r)), cwd=root,
                stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                alive = [r for r, p in enumerate(procs) if p.poll() is None]
                raise TimeoutError(
                    f"ranks {alive} of {nprocs} still running after "
                    f"{timeout:.0f} s; killed (logs: {out_dir}/rank*.log)")
            time.sleep(0.05)
        return [p.returncode for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()


def _load(path: str):
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "flexflow_tpu_torch.runtime.mesh_run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("target", help="a Python file with "
                    "run(rank, world, device, args)")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    a = ap.parse_args(argv)
    from . import distributed as rdist

    rank, world, _ = rdist.init_distributed(device=a.device, timeout_s=90)
    try:
        return int(_load(a.target).run(rank, world, a.device, a.args) or 0)
    finally:
        rdist.shutdown()


if __name__ == "__main__":
    sys.exit(main())
