"""The measurement entry points refuse to run without a GPU."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('script', ['chip_smoke.py', 'bench.py'])
def test_exits_nonzero_without_gpu(script):
    """Under JAX_PLATFORMS=cpu the script exits non-zero and prints no
    result line: no CPU number is ever reported as a device metric."""
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, os.path.join(REPO, script)],
                         env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert 'evals/s' not in out.stdout
    assert 'no GPU' in out.stderr
