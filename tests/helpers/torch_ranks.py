"""Run a Python script as the ranks of a ``torch.distributed`` gloo group on
the CPU, for the port's multi-process tests.

Each rank is its own interpreter (``python -c script``) with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``ANOMALYCLIP_DIST_TIMEOUT_S``, so a hung
collective raises in the ranks. Before the script, each rank of a launch of
more than one joins the gloo group at ``file://<dir>/rendezvous`` (a file per
launch: no port to race for under xdist), as a launcher does before it calls
an entry point; the script's own ``init_distributed`` then keeps that group.
The script sees the init method as ``RENDEZVOUS``. The ranks are joined with a
timeout that kills every one of them: a hang fails the test that launched it
and never the whole suite."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Sequence

REPO_ROOT = Path(__file__).resolve().parents[2]
COLLECTIVE_TIMEOUT_S = 60

# run first in every rank: join the launch's group (a world of one joins none)
_JOIN = (
    "RENDEZVOUS = {init_method!r}\n"
    "from anomalyclip_tpu_torch.parallel import mesh as _mesh\n"
    "_mesh.init_distributed(backend='gloo', init_method=RENDEZVOUS)\n"
)


def launch(script: str, ranks: int, workdir: Path, args: Sequence[str] = (),
           env: Optional[dict] = None, threads: int = 1) -> List[subprocess.Popen]:
    """Start ``ranks`` interpreters running ``script`` with ``args``."""
    workdir.mkdir(parents=True, exist_ok=True)
    rendezvous = workdir / "rendezvous"
    if rendezvous.exists():
        rendezvous.unlink()
    base = dict(os.environ, PYTHONPATH=str(REPO_ROOT), WORLD_SIZE=str(ranks),
                ANOMALYCLIP_DIST_TIMEOUT_S=str(COLLECTIVE_TIMEOUT_S),
                OMP_NUM_THREADS=str(threads), **(env or {}))
    joined = _JOIN.format(init_method=f"file://{rendezvous}") + script
    return [
        subprocess.Popen([sys.executable, "-c", joined, *map(str, args)], cwd=REPO_ROOT,
                         env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, start_new_session=True)
        for r in range(ranks)
    ]


def join(procs: List[subprocess.Popen], timeout: float = 110) -> List[str]:
    """Wait for every rank, killing all of them (and what they started) when
    one fails or the time is up -> their outputs; raises with every rank's
    errors unless all exited 0."""
    outs, errs, failed = [], [], False
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=timeout)
            outs.append(out)
            errs.append(err)
            failed = failed or proc.returncode != 0
    except subprocess.TimeoutExpired:
        failed = True
        errs.append(f"timed out after {timeout} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    if failed:
        detail = "\n".join(f"--- rank {r} rc={p.returncode}\n{e[-4000:]}"
                           for r, (p, e) in enumerate(zip(procs, errs + [""] * len(procs))))
        raise AssertionError(f"a rank failed:\n{detail}")
    return outs


def run(script: str, ranks: int, workdir: Path, args: Sequence[str] = (), env: Optional[dict] = None,
        timeout: float = 110) -> List[str]:
    return join(launch(script, ranks, workdir, args, env), timeout)
