"""Wall seconds of each phase of ``chip_smoke.py``.

Runs ``python3 -u chip_smoke.py`` from the root of a tree and stamps each
line it prints with the seconds since the start. The full stamped lines
go to ``chiprun_out/<name>.log``; standard output gets one short line per
printed line: name, stamp, seconds since the line before, the record's
``phase`` (or its first key) and the ``seconds`` the phase reports of
itself. Two trees run one after the other in one call (the parent and a
change, then in the other order) tell a phase that grew from a machine
that was slower.

Usage:
  python -m rbc_gym_tpu_torch.scripts.smoke_times TREE NAME
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def label(line: str):
    """(phase or first key, the phase's own seconds or None) of a printed
    line; a line that is no JSON object is its own label, cut to 160."""
    try:
        obj = json.loads(line)
    except ValueError:
        obj = None
    if not isinstance(obj, dict):
        return line.strip()[:160], None
    return obj.get("phase") or ",".join(list(obj)[:2]), obj.get("seconds")


def main(argv=None) -> int:
    tree, name = (argv or sys.argv[1:])[:2]
    os.makedirs("chiprun_out", exist_ok=True)
    start = last = time.time()
    proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"], cwd=tree,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    with open(os.path.join("chiprun_out", f"{name}.log"), "w") as log:
        for line in proc.stdout:
            now = time.time()
            log.write(f"{now - start:9.2f} {line}")
            log.flush()
            text, seconds = label(line)
            print(f"{name} {now - start:9.2f} +{now - last:8.2f} {text} "
                  f"{'' if seconds is None else seconds}", flush=True)
            last = now
    rc = proc.wait()
    print(f"{name} rc={rc} total={time.time() - start:.2f}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
