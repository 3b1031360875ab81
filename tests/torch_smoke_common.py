"""Helpers that the ``tests/test_torch_smoke*.py`` files share (not
collected itself): the repo's paths, the tiny 2D state shape the phases'
rehearsals run at, a subprocess runner and a fixture of one torch thread."""

import subprocess
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "rbc_gym_tpu_torch"
TINY = dict(state_shape=(16, 32))


def _run(args, cwd=REPO, env=None, timeout=300):
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several processes
    on a few cores, where torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
