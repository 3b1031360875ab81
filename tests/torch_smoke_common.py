"""Helpers that the ``tests/test_torch_*.py`` files share (not collected
itself): the repo's paths, the tiny 2D state shape the smoke phases'
rehearsals run at, a subprocess runner, the fixture of one thread (every
``tests/test_torch_*.py`` that has no autouse fixture of its own imports
``one_thread_a_module``, which makes it autouse there) and the build of
the kernels' host emulation, once a test run."""

import contextlib
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "rbc_gym_tpu_torch"
TINY = dict(state_shape=(16, 32))


def _run(args, cwd=REPO, env=None, timeout=300):
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module", autouse=True)
def one_thread_a_module():
    """One torch intra-op thread and one BLAS thread for numpy (through
    threadpoolctl, where it is installed) for a whole test file, its module
    fixtures included; autouse in every file that imports it. The suite
    runs in six processes on a few cores, where the thread pools would
    oversubscribe them: OpenBLAS's spinning threads made a numpy inversion
    of a 224 x 224 matrix some 300 times slower there."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        blas = contextlib.nullcontext()
    else:
        blas = threadpool_limits(limits=1, user_api="blas")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with blas:
        yield
    torch.set_num_threads(n)


HOST_CXX_FLAGS = ("-std=c++20", "-O1", "-pthread")


def host_binary(tmp_path_factory, name: str, program: str):
    """The host build of ``csrc/<name>`` (``_build.host_source``) with the
    test driver ``program``, compiled once a test run: the binary is cached
    under the run's temporary root (shared by its xdist workers), keyed by a
    hash of the program, the source and every header of ``csrc/``, and the
    first worker to need it builds it under a file lock while the others
    wait. Skips where there is no host C++ compiler."""
    from rbc_gym_tpu_torch.ops import _build

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler to build the kernels' host emulation")
    stem = Path(name).stem
    source = _build.host_source(name)
    h = hashlib.sha256(" ".join((gxx, *HOST_CXX_FLAGS)).encode())
    for text in (program, source):
        h.update(text.encode())
    for header in sorted((*_build.CSRC_DIR.glob("*.h"), *_build.CSRC_DIR.glob("*.cuh"))):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    base = tmp_path_factory.getbasetemp()
    root = (base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base) / "host_binaries"
    root.mkdir(parents=True, exist_ok=True)
    d = root / f"{stem}_{h.hexdigest()[:16]}"
    exe = d / "host_program"
    with open(root / f"{d.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not exe.exists():
            d.mkdir(exist_ok=True)
            (d / f"{stem}_host.h").write_text(source)
            (d / "host_program.cpp").write_text(program)
            proc = subprocess.run([gxx, *HOST_CXX_FLAGS, "-o", str(d / "host_program.tmp"),
                                   str(d / "host_program.cpp")], capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr
            (d / "host_program.tmp").rename(exe)
    return exe
