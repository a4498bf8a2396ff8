"""The port's native helper library (``vri_tpu_torch/_native.py``) is
built from ``native/src`` into ``vri_tpu_torch/_build/`` and loaded under
a cross-process lock.

The JAX package's own copy, ``native/libvri_native.so``, is built in
place by ``make`` on first use (``vri_tpu.runtime.native``); a process
that loads it while another is still writing it falls back to numpy for
its whole life.  Every test worker process collects every test module
before any test runs, so the calls below make each worker pass through a
lock on both libraries first: one builds, the others wait and load a
whole file.
"""

import fcntl
import os
import subprocess
import sys

import vri_tpu_torch
from vri_tpu.runtime import native as jax_native
from vri_tpu_torch import _native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ensure_reference_library() -> bool:
    """Build (if missing) and load ``native/libvri_native.so`` under an
    ``flock`` beside it."""
    lock = os.path.join(jax_native._NATIVE_DIR, ".libvri_native.lock")
    with open(lock, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            jax_native.ensure_built()
            return jax_native.available()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


_ensure_reference_library()
_native.ensure_native()

_RACE = r"""
import sys

from vri_tpu_torch import _native

_native.BUILD_DIR = sys.argv[1]
ok = _native.ensure_native()
print(int(ok), _native._lib.vri_abi_version() if ok else -1)
"""


def test_racing_processes_load_a_whole_library(tmp_path):
    """Six processes call ``ensure_native`` at once on an empty build
    directory: each ends with a loaded library of ABI version 3 (none
    falls back to numpy), built from ``native/src`` into that directory;
    ``native/`` gains no file."""
    before = sorted(os.listdir(os.path.join(REPO, "native")))
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(build)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.split() == ["1", "3"], (out, err[-2000:])
    libs = [n for n in os.listdir(build) if n.endswith(".so")]
    assert libs == [os.path.basename(_native.lib_path())]
    assert (build / _native.LOCK_NAME).exists()
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before


def test_port_library_lives_in_its_build_dir():
    """The port loads its own build, never ``native/libvri_native.so``."""
    assert _native.ensure_native()
    path = _native.lib_path()
    assert os.path.dirname(path) == os.path.join(
        REPO, "vri_tpu_torch", "_build")
    assert os.path.exists(path)
    assert _native._lib._name == path


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
    d = RenderDelegate(vri_tpu_torch.RenderConfig(width=32, height=32,
                                                  sync_workers=2),
                       device="cpu")
    d.populate(vri_tpu_torch.scenes.cornell_box())
    d.sync()
    assert calls == [1]
