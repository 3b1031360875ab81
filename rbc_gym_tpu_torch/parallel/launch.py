"""Run a command as R ranks on this host.

What torchrun does for one host, without its agent process: each rank
gets torchrun's variables (``MASTER_ADDR``/``MASTER_PORT`` on a local
port held for the ranks while they run, ``reserved_port``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), so
``parallel.initialize_distributed`` joins them.
A rank that fails stops the others, and so does the time limit: no rank
is left waiting in a collective.
"""

from __future__ import annotations

import contextlib
import os
import signal
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence


@contextlib.contextmanager
def reserved_port():
    """Yield a local TCP port that stays reserved for the ranks inside: a
    socket holds it bound with ``SO_REUSEADDR`` and does not listen, so
    no other socket on the host is given it (a bind to port 0 passes it
    over, a plain bind to it is refused) while rank 0's ``TCPStore``, which
    binds with ``SO_REUSEADDR`` too, can listen on it. A port that was
    free when it was picked and released before rank 0 bound it could be
    taken in between by another process on the host, failing rank 0's
    bind or handing rank 1 to another process's listener."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("localhost", 0))
        yield s.getsockname()[1]


def run_ranks(argv: Sequence[str], nproc: int, env: Optional[Dict[str, str]] = None,
              timeout: float = 600.0, cwd=None) -> List[str]:
    """Run ``argv`` as ``nproc`` ranks, each in a session of its own, with
    ``env`` over this process's environment; returns each rank's output
    (standard output and error). If a rank exits non-zero or the ranks
    outlast ``timeout`` seconds, every rank still running is killed with
    its session and this raises with the tail of each rank's output."""
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        common = {**os.environ, **(env or {}), "MASTER_ADDR": "localhost",
                  "MASTER_PORT": str(stack.enter_context(reserved_port())),
                  "WORLD_SIZE": str(nproc), "LOCAL_WORLD_SIZE": str(nproc)}
        logs = [stack.enter_context(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
                for r in range(nproc)]
        procs = [subprocess.Popen(list(argv), env={**common, "RANK": str(r), "LOCAL_RANK": str(r)},
                                  cwd=cwd, stdout=logs[r], stderr=subprocess.STDOUT,
                                  start_new_session=True)
                 for r in range(nproc)]
        deadline, timed_out = time.monotonic() + timeout, False
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed or timed_out:
        why = f"timed out after {timeout} s" if timed_out else f"rank(s) {failed} failed"
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{outputs[r][-3000:]}"
                          for r, p in enumerate(procs))
        raise RuntimeError(f"{' '.join(argv)} as {nproc} ranks: {why}\n{tails}")
    return outputs
