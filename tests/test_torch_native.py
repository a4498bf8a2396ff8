"""The native helper library is built and loaded under a cross-process
lock (``vri_tpu_torch/_native.py``).

``vri_tpu.runtime.native`` builds ``native/libvri_native.so`` with
``make`` when it is missing, writing the file in place; a process that
loads it half-written falls back to numpy for its whole life.  Every
test worker process collects every test module before any test runs, so
the call below makes each worker pass through the lock first: one builds
the library, the others wait and load a whole file.
"""

import os
import shutil
import subprocess
import sys

from vri_tpu.config import RenderConfig
from vri_tpu.usd import scenes
from vri_tpu_torch import _native

_native.ensure_native()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RACE = r"""
import os
import sys

from vri_tpu.runtime import native

native._NATIVE_DIR = sys.argv[1]
native._LIB_PATH = os.path.join(sys.argv[1], "libvri_native.so")
from vri_tpu_torch import _native

ok = _native.ensure_native()
print(int(ok), native._lib.vri_abi_version() if ok else -1)
"""


def test_racing_processes_load_a_whole_library(tmp_path):
    """Six processes call ``ensure_native`` at once on a copy of
    ``native/`` without the library: each ends with a loaded library of
    ABI version 3 (none falls back to numpy)."""
    nat = tmp_path / "native"
    shutil.copytree(os.path.join(REPO, "native"), nat,
                    ignore=shutil.ignore_patterns("*.so", ".*"))
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(nat)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.split() == ["1", "3"], (out, err[-2000:])
    assert (nat / "libvri_native.so").exists()
    assert (nat / _native.LOCK_NAME).exists()


def test_delegate_sync_takes_the_lock(monkeypatch):
    """The port's delegate loads the library through ``ensure_native``
    before it starts its sync thread pool."""
    from vri_tpu_torch.hydra.delegate import RenderDelegate

    calls = []
    real = _native.ensure_native

    def spy():
        calls.append(1)
        return real()

    monkeypatch.setattr(_native, "ensure_native", spy)
    d = RenderDelegate(RenderConfig(width=32, height=32, sync_workers=2),
                       device="cpu")
    d.populate(scenes.cornell_box())
    d.sync()
    assert calls == [1]

