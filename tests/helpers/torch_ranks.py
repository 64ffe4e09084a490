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
and never the whole suite, and the failure shows each rank's seconds since its
launch and the ends of what it wrote before the kill."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
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
        started(subprocess.Popen([sys.executable, "-c", joined, *map(str, args)], cwd=REPO_ROOT,
                                 env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, start_new_session=True))
        for r in range(ranks)
    ]


def started(proc: subprocess.Popen) -> subprocess.Popen:
    """Stamp ``proc`` with its launch time, which ``join`` reports."""
    proc.launched_at = time.monotonic()
    return proc


def join(procs: List[subprocess.Popen], timeout: float = 110) -> List[str]:
    """Wait for every rank, killing all of them (and what they started) when
    one fails or the time is up -> their outputs; raises unless all exited 0,
    with each rank's return code, its seconds since launch and the ends of its
    stdout and stderr (a killed rank's too: what it wrote before the kill)."""
    joined_at = time.monotonic()
    outs, errs, ended, failed, timed_out = {}, {}, {}, False, None

    def since_launch(proc):
        return time.monotonic() - getattr(proc, "launched_at", joined_at)

    try:
        for r, proc in enumerate(procs):
            outs[r], errs[r] = proc.communicate(timeout=timeout)
            ended[r] = since_launch(proc)
            failed = failed or proc.returncode != 0
    except subprocess.TimeoutExpired:
        failed, timed_out = True, r
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
    for r, proc in enumerate(procs):
        if r not in outs:  # killed, or left unread: collect what it wrote
            ended[r] = since_launch(proc)
            try:
                outs[r], errs[r] = proc.communicate(timeout=30)
            except subprocess.TimeoutExpired:  # a child outside the group holds the pipe
                outs[r], errs[r] = "", "(its pipes stayed open after the kill)"
    if failed:
        detail = "\n".join(
            f"--- rank {r} rc={p.returncode} after {ended[r]:.1f} s"
            + (f" (timed out: {timeout} s)" if r == timed_out else "")
            + f"\n[stdout]\n{outs[r][-3000:]}\n[stderr]\n{errs[r][-4000:]}"
            for r, p in enumerate(procs))
        raise AssertionError(f"a rank failed:\n{detail}")
    return [outs[r] for r in range(len(procs))]


def run(script: str, ranks: int, workdir: Path, args: Sequence[str] = (), env: Optional[dict] = None,
        timeout: float = 110) -> List[str]:
    return join(launch(script, ranks, workdir, args, env), timeout)
