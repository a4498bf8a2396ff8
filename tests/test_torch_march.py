"""The port's march (kernel M's plain version) against the JAX package's
march kernels, K3 (``march_stream``) and K4 (``march``), run in Pallas
interpret mode on the CPU.

Both sides march the same rays through the same cascade tables (the JAX
build carried across with ``cascades_from_numpy``).  Tolerances:

* hit voxel, iteration count, hit flag, cascade and brick exactly equal
  on every ray: the port follows the reference step's operation order to
  the letter, so every ray visits the same voxels.
* t within rtol 5e-6 (a few tens of float32 ulps), with the count of rays
  whose t is not bit-equal printed: XLA:CPU contracts the step's
  multiply-adds (``o + d * t``, ``exit + 0.01 * vs``) into fused ones,
  the port rounds each operation (as its CUDA kernel, built with
  -fmad=false, does), so t drifts by ulps along a ray without moving it
  to another voxel.  ``test_march_bit_equal_without_contraction`` proves
  that this is the only difference: with an XLA:CPU that has no fused
  multiply-add, t is bit-equal on every ray.
* uvw within 1e-4 (the hit point o + d * t over the voxel size inherits
  that drift).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from vri_tpu.config import RenderConfig, SDFConfig  # noqa: E402
from vri_tpu.hydra import RenderDelegate  # noqa: E402
from vri_tpu.ops import march_kernel as jmarch  # noqa: E402
from vri_tpu.ops import sdf as jsdf  # noqa: E402
from vri_tpu.ops import sdf_build as jbuild  # noqa: E402
from vri_tpu.ops import sdf_trace as jtrace  # noqa: E402
from vri_tpu.registry import bake_world as jbake_world  # noqa: E402
from vri_tpu.usd import scenes  # noqa: E402
from vri_tpu_torch.ops import march_kernel as tmarch  # noqa: E402
from vri_tpu_torch.ops import sdf as tsdf  # noqa: E402
from vri_tpu_torch.ops import sdf_trace as ttrace  # noqa: E402

# s = 1 (r=16) and s = 4 (r=64) voxels per coarse cell
CONFIGS = {
    "r16": SDFConfig(num_cascades=2, cascade_resolution=16, brick_size=8,
                     max_bricks=4096, base_voxel_size=0.15,
                     truncation_voxels=1.0, max_triangles_per_brick=16,
                     march_max_steps=48),
    "r64": SDFConfig(num_cascades=2, cascade_resolution=64, brick_size=8,
                     max_bricks=16384, base_voxel_size=0.075,
                     truncation_voxels=3.0, max_triangles_per_brick=16),
}
M = 4096          # rays; 2 queue blocks of K3 at queue=2
STEPS = 96


def _to_port(cas):
    return tsdf.cascades_from_numpy(
        {f.name: np.asarray(getattr(cas, f.name))
         for f in dataclasses.fields(cas) if getattr(cas, f.name) is not None},
        "cpu")


def _rays(cas, cfg, seed):
    """Rays as in tests/test_march_kernel.py: random origins in the box
    kept off the surface band, random unit directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.85, 0.85, (3 * M, 3)).astype(np.float32)
    d = rng.normal(size=(3 * M, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dist = np.asarray(jtrace._sample(cas, jnp.asarray(o), cfg)[0])
    keep = np.nonzero(dist > 1.2 * cfg.base_voxel_size)[0][:M]
    assert len(keep) == M
    return o[keep], d[keep]


def _reference(name, forms=("stream", "block", "occl")):
    """JAX side for one configuration: the Cornell cascades, the rays and
    the reference marches named in ``forms``."""
    cfg = CONFIGS[name]
    dlg = RenderDelegate(RenderConfig(width=32, height=32))
    dlg.populate(scenes.cornell_box())
    s = dlg.sync()
    cas, _ = jbuild.build_for_scene(
        s, jbake_world(s), jsdf.default_centers(cfg, np.zeros(3)), cfg)
    o, d = _rays(cas, cfg, seed=list(CONFIGS).index(name))
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    kw = dict(t_max=10.0, config=cfg, max_steps=STEPS, interpret=True)
    run = {"stream": lambda: jmarch.march_stream(cas, jo, jd, queue=2,
                                                 service_every=2, **kw),
           "block": lambda: jmarch.march(cas, jo, jd, **kw),
           "occl": lambda: jmarch.march(cas, jo, jd, payload=False, **kw)}
    return cas, o, d, {k: run[k]() for k in forms}


@pytest.fixture(scope="module")
def marches():
    out = {}
    for name, cfg in CONFIGS.items():
        cas, o, d, ref = _reference(name)
        tcas = _to_port(cas)
        to, td = torch.as_tensor(o), torch.as_tensor(d)
        got = {"full": tmarch.march(tcas, to, td, 10.0, config=cfg,
                                    max_steps=STEPS),
               "occl": tmarch.march(tcas, to, td, 10.0, config=cfg,
                                    max_steps=STEPS, payload=False)}
        out[name] = (cfg, tcas, ref, got, o, d)
    return out


def _assert_hits_equal(ref, got):
    hit = np.asarray(ref.hit)
    print(f"  {hit.mean():.3f} hit, mean {np.asarray(ref.iterations).mean():.1f}"
          " iterations")
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.voxel.numpy(), np.asarray(ref.voxel))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    t_ref = np.asarray(ref.t)
    print(f"  t not bit-equal on {int((got.t.numpy() != t_ref).sum())} of "
          f"{t_ref.size} rays")
    np.testing.assert_allclose(got.t.numpy(), t_ref, rtol=5e-6)
    np.testing.assert_array_equal(got.cascade.numpy(),
                                  np.asarray(ref.cascade))


@pytest.mark.parametrize("kernel", ["stream", "block"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_march_matches_kernels(marches, name, kernel):
    _, _, ref, got, _, _ = marches[name]
    _assert_hits_equal(ref[kernel], got["full"])
    np.testing.assert_array_equal(got["full"].brick.numpy(),
                                  np.asarray(ref[kernel].brick))
    np.testing.assert_allclose(got["full"].uvw.numpy(),
                               np.asarray(ref[kernel].uvw), atol=1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_occlusion_form_matches(marches, name):
    _, _, ref, got, _, _ = marches[name]
    _assert_hits_equal(ref["occl"], got["occl"])
    np.testing.assert_array_equal(got["occl"].brick.numpy(),
                                  np.asarray(ref["occl"].brick))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trace_dispatch_budget(marches, name):
    """sdf_trace.occlusion marches with the TPU branch's budget
    max_steps * 2 + 16 and payload=False."""
    cfg, tcas, _, _, o, d = marches[name]
    to, td = torch.as_tensor(o[:256]), torch.as_tensor(d[:256])
    occ = ttrace.occlusion(tcas, to, td, 10.0, config=cfg, max_steps=20)
    direct = tmarch.march(tcas, to, td, 10.0, config=cfg, max_steps=56,
                          payload=False)
    np.testing.assert_array_equal(occ.numpy(), 1.0 - direct.hit.float().numpy())
    with pytest.raises(NotImplementedError):
        ttrace.march(tcas, to, td, 10.0, config=cfg, approx=False)


_NO_FMA_REFERENCE = r"""
import sys
import dataclasses
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import test_torch_march as T
out = {}
for name in T.CONFIGS:
    cas, o, d, ref = T._reference(name, forms=("stream", "block"))
    for f in dataclasses.fields(cas):
        a = getattr(cas, f.name)
        if a is not None:
            a = np.asarray(a)
            out[f"{name}/cas/{f.name}"] = (a.astype(np.float32)
                                           if a.dtype.name == "bfloat16"
                                           else a)
    out[f"{name}/o"], out[f"{name}/d"] = o, d
    for form, rec in ref.items():
        for key in ("t", "voxel", "iterations"):
            out[f"{name}/{form}/{key}"] = np.asarray(getattr(rec, key))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def no_fma_reference(tmp_path_factory):
    """K3 and K4 interpreted by an XLA:CPU limited to AVX, which has no
    fused multiply-add, so XLA cannot contract the step's products and
    sums: the reference then rounds every operation as the port does.
    Runs in its own interpreter because XLA reads its flags once."""
    path = tmp_path_factory.mktemp("no_fma") / "ref.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([tests, os.path.dirname(tests)]))
    proc = subprocess.run([sys.executable, "-c", _NO_FMA_REFERENCE,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("kernel", ["stream", "block"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_march_bit_equal_without_contraction(no_fma_reference, name, kernel):
    """With contraction ruled out on the JAX side, t, the hit voxel and
    the iteration count are bit-equal on every ray: the port reproduces
    the reference step's operation order exactly."""
    ref = no_fma_reference
    tcas = tsdf.cascades_from_numpy(
        {k.split("/")[-1]: v for k, v in ref.items()
         if k.startswith(f"{name}/cas/")}, "cpu")
    got = tmarch.march(tcas, torch.as_tensor(ref[f"{name}/o"]),
                       torch.as_tensor(ref[f"{name}/d"]), 10.0,
                       config=CONFIGS[name], max_steps=STEPS)
    for key in ("t", "voxel", "iterations"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      ref[f"{name}/{kernel}/{key}"])
