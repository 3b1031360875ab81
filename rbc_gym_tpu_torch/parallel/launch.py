"""Run a command as R ranks on this host.

What torchrun does for one host: each rank gets torchrun's variables
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), so ``parallel.initialize_distributed``
joins them, and, as torchrun's agent does, this process hosts the ranks'
rendezvous store: a ``TCPStore`` listening on a port the host hands out
(port 0) before any rank starts, which every rank joins as a client
(``TORCHELASTIC_USE_AGENT_STORE=True``). No port is picked ahead and
released, so no other process on the host can take the ranks' port while
they start. A rank that fails stops the others, and so does the time
limit: no rank is left waiting in a collective.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import signal
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence


def rendezvous_store(timeout: float):
    """A ``TCPStore`` server of this process on a port the host picks,
    listening once this returns; its ``.port`` is the ranks' ``MASTER_PORT``."""
    from torch.distributed import TCPStore

    return TCPStore("localhost", 0, is_master=True, wait_for_workers=False,
                    timeout=datetime.timedelta(seconds=timeout))


def run_ranks(argv: Sequence[str], nproc: int, env: Optional[Dict[str, str]] = None,
              timeout: float = 600.0, cwd=None) -> List[str]:
    """Run ``argv`` as ``nproc`` ranks, each in a session of its own, with
    ``env`` over this process's environment, joined through this process's
    store (``rendezvous_store``); returns each rank's output (standard
    output and error). If a rank exits non-zero or the ranks outlast
    ``timeout`` seconds, every rank still running is killed with its
    session and this raises with the tail of each rank's output."""
    store = rendezvous_store(timeout)
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        common = {**os.environ, **(env or {}), "MASTER_ADDR": "localhost",
                  "MASTER_PORT": str(store.port), "TORCHELASTIC_USE_AGENT_STORE": "True",
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
    del store
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed or timed_out:
        why = f"timed out after {timeout} s" if timed_out else f"rank(s) {failed} failed"
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{outputs[r][-3000:]}"
                          for r, p in enumerate(procs))
        raise RuntimeError(f"{' '.join(argv)} as {nproc} ranks: {why}\n{tails}")
    return outputs
