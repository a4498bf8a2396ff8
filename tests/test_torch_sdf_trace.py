"""The port's trilinear SDF march (``vri_tpu_torch.ops.sdf_trace``) against
``vri_tpu.ops.sdf_trace``, and the march dispatch's kernel tier.

Both sides read the same cascades: the JAX package builds and bakes the
Cornell box at a two-cascade r=64 configuration with ``kernel_march``
off, and the port gets the arrays (``cascades_from_numpy``).  The JAX
functions run eagerly (``_sample`` is not jitted; ``march``, ``normal``
and ``direct_radiance_cached`` under ``jax.disable_jit()``), so XLA
compiles one operation at a time and contracts no multiply-add: both
sides round every operation.  Tolerances, and why:

* ``_sample``, trilinear and nearest texel, u8 and f32 atlas, on points
  near the box's surfaces and far outside both cascades, with ray
  directions that have zero components: every output bit-equal (same
  operations in the same order).
* ``march`` (approx False and True with ``kernel_march`` off, compact
  False and True): ``hit``, ``iterations``, ``cascade`` and ``brick``
  equal on at least 99.9% of the rays, ``t`` and ``uvw`` within rtol
  1e-5 where both hit; the counts are printed.  The port's compact march
  equals its one-stage march bit for bit on these rays, none of which
  exhausts the budget (checked).  At a budget the rays exhaust, the JAX
  compact loop marches past it (its cleanup resumes the compacted rays);
  the port's does the same, every output bit-equal.
* with ``kernel_march`` on, ``march`` (``compact`` or not) and
  ``occlusion`` (``compact_march`` or not) take one-phase
  ``march_kernel.march`` (the kernel's plain version here) in one call,
  bit for bit.
* ``normal`` and ``direct_radiance_cached`` within 1e-5 (a vector norm
  and light sums, summed in another order).
* ``sdf_debug_color``, all six modes, on the same march record: within
  1e-6.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import vri_tpu_torch  # noqa: E402
from vri_tpu.config import DebugMode, RenderConfig, SDFConfig  # noqa: E402
from vri_tpu.hydra import RenderDelegate  # noqa: E402
from vri_tpu.ops import gi as jgi  # noqa: E402
from vri_tpu.ops import sdf as jsdf  # noqa: E402
from vri_tpu.ops import sdf_build as jbuild  # noqa: E402
from vri_tpu.ops import sdf_trace as jtrace  # noqa: E402
from vri_tpu.registry import bake_world as jbake_world  # noqa: E402
from vri_tpu.usd import scenes  # noqa: E402
from vri_tpu_torch.hydra import delegate as tdelegate  # noqa: E402
from vri_tpu_torch.ops import gi as tgi  # noqa: E402
from vri_tpu_torch.ops import march_kernel as tmarch  # noqa: E402
from vri_tpu_torch.ops import sdf as tsdf  # noqa: E402
from vri_tpu_torch.ops import sdf_trace as ttrace  # noqa: E402

CFG_ARGS = dict(num_cascades=2, cascade_resolution=64, brick_size=8,
                max_bricks=16384, base_voxel_size=0.075,
                truncation_voxels=3.0, max_triangles_per_brick=16,
                kernel_march=False)
CFG = SDFConfig(**CFG_ARGS)
TCFG = vri_tpu_torch.SDFConfig(**CFG_ARGS)
M = 2048          # march rays: the compact stage engages from 512
STEPS = 96


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def sides():
    """The JAX cascades (built and baked) and scene, and the port's copy
    of the cascades with its own scene of the same stage."""
    dlg = RenderDelegate(RenderConfig(width=32, height=32))
    dlg.populate(scenes.cornell_box())
    scene = dlg.sync()
    cas, st = jbuild.build_for_scene(
        scene, jbake_world(scene), jsdf.default_centers(CFG, np.zeros(3)),
        CFG)
    cas = jsdf.bake_brick_lighting(cas, scene, config=CFG, alive=st.alive)
    tcas = tsdf.cascades_from_numpy(
        {f.name: _np(getattr(cas, f.name)) for f in dataclasses.fields(cas)
         if getattr(cas, f.name) is not None}, "cpu")
    tdlg = tdelegate.RenderDelegate(
        vri_tpu_torch.RenderConfig(width=32, height=32), device="cpu")
    tdlg.populate(vri_tpu_torch.scenes.cornell_box())
    return cas, tcas, scene, tdlg.sync()


def _points(seed):
    """Points near the box's surfaces and far outside both cascades (the
    coarse one spans [-4.8, 4.8]), with unit directions, a quarter of
    them with one or two zero components."""
    rng = np.random.default_rng(seed)
    p = np.concatenate([rng.uniform(-1.1, 1.1, (3072, 3)),
                        rng.uniform(-7.0, 7.0, (1024, 3))]).astype(np.float32)
    d = rng.normal(size=p.shape).astype(np.float32)
    d[::4, rng.integers(0, 3)] = 0.0
    d[::8, rng.integers(0, 3)] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d


@pytest.mark.parametrize("atlas", ["u8", "f32"])
@pytest.mark.parametrize("trilinear", [True, False])
def test_sample_bit_equal(sides, trilinear, atlas):
    cas, tcas, _, _ = sides
    if atlas == "f32":
        a = np.asarray(cas.atlas).astype(np.float32) / 255.0
        cas = cas.replace(atlas=jnp.asarray(a))
        tcas = tcas.replace(atlas=torch.as_tensor(a))
    p, d = _points(seed=3 + trilinear)
    names = ("d", "cascade", "brick", "uvw", "inside", "exit_t")
    for dirs in (None, d):
        ref = jtrace._sample(cas, jnp.asarray(p), CFG,
                             None if dirs is None else jnp.asarray(dirs),
                             trilinear=trilinear)
        got = ttrace._sample(tcas, torch.as_tensor(p), TCFG,
                             None if dirs is None else torch.as_tensor(dirs),
                             trilinear=trilinear)
        inside = np.asarray(ref[4])
        print(f"trilinear={trilinear} {atlas}: {inside.mean():.3f} of the "
              f"points inside a cascade, "
              f"{float((np.asarray(ref[2]) >= 0).mean()):.3f} in a brick")
        for name, r, g in zip(names, ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=name)


def _march_rays(cas, seed):
    """Rays as in tests/test_march_kernel.py: origins in the box kept off
    the surface band, random unit directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.85, 0.85, (3 * M, 3)).astype(np.float32)
    d = rng.normal(size=(3 * M, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dist = np.asarray(jtrace._sample(cas, jnp.asarray(o), CFG)[0])
    keep = np.nonzero(dist > 1.2 * CFG.base_voxel_size)[0][:M]
    assert len(keep) == M
    return o[keep], d[keep]


@pytest.fixture(scope="module")
def marches(sides):
    """Both sides' marches of the same rays in every (approx, compact)
    form, the JAX side eagerly."""
    cas, tcas, _, _ = sides
    o, d = _march_rays(cas, seed=11)
    out = {}
    for approx in (False, True):
        for compact in (False, True):
            kw = dict(max_steps=STEPS, approx=approx, compact=compact)
            with jax.disable_jit():
                ref = jtrace.march(cas, jnp.asarray(o), jnp.asarray(d), 10.0,
                                   config=CFG, **kw)
            got = ttrace.march(tcas, torch.as_tensor(o), torch.as_tensor(d),
                               10.0, config=TCFG, **kw)
            out[approx, compact] = (ref, got)
    return o, d, out


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("approx", [False, True])
def test_march_matches(marches, approx, compact):
    ref, got = marches[2][approx, compact]
    same = np.ones(M, bool)
    for key in ("hit", "iterations", "cascade", "brick"):
        eq = getattr(got, key).numpy() == np.asarray(getattr(ref, key))
        print(f"approx={approx} compact={compact}: {key} differs on "
              f"{int((~eq).sum())} of {M} rays")
        same &= eq
    hit = np.asarray(ref.hit)
    both = same & hit
    t_eq = int((got.t.numpy()[both] == np.asarray(ref.t)[both]).sum())
    mean_it = np.asarray(ref.iterations).mean()
    print(f"  {hit.mean():.3f} hit, mean {mean_it:.1f} iterations; t "
          f"bit-equal on {t_eq} of {int(both.sum())} hits")
    assert same.mean() >= 0.999
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=1e-5)
    np.testing.assert_allclose(got.uvw.numpy()[both],
                               np.asarray(ref.uvw)[both], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("approx", [False, True])
def test_compact_loop_equals_plain_loop(marches, approx):
    """The two-stage loop gives the one-stage loop's result on every
    ray: no ray of this set is still marching when the budget ends."""
    plain = marches[2][approx, False][1]
    compact = marches[2][approx, True][1]
    assert int(plain.iterations.max()) < STEPS
    for f in dataclasses.fields(plain):
        a, b = getattr(plain, f.name), getattr(compact, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name


def test_trace_compact_dispatch(sides):
    """With kernel_march on, sdf_trace.march(approx=True, compact=True)
    and occlusion under compact_march take one-phase march_kernel.march,
    one march_rays call each, with the TPU branch's budget
    max_steps * 2 + 16: bit for bit its result."""
    _, tcas, _, _ = sides
    cfg = dataclasses.replace(TCFG, kernel_march=True, compact_march=True)
    rng = np.random.default_rng(5)
    o = torch.as_tensor(rng.uniform(-0.9, 0.9, (4096, 3)).astype(np.float32))
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True))
    ref = tmarch.march(tcas, o, d, 10.0, config=cfg, max_steps=56)
    calls = []
    real = tmarch.march_rays

    def counted(*args, **kw):
        calls.append(kw["max_steps"])
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmarch, "march_rays", counted)
        got = ttrace.march(tcas, o, d, 10.0, config=cfg, max_steps=20,
                           approx=True, compact=True)
        occ = ttrace.occlusion(tcas, o, d, 10.0, config=cfg, max_steps=20)
    assert calls == [56, 56]
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), \
            f.name
    assert torch.equal(occ, 1.0 - ref.hit.float())


def test_normal_matches(sides, marches):
    cas, tcas, _, _ = sides
    o, d, out = marches
    ref = out[False, False][0]
    hit = np.asarray(ref.hit)
    p = (o + d * np.asarray(ref.t)[:, None])[hit]
    with jax.disable_jit():
        want = np.asarray(jtrace.normal(cas, jnp.asarray(p), config=CFG))
    got = ttrace.normal(tcas, torch.as_tensor(p), config=TCFG).numpy()
    print(f"normal: {len(p)} hit points, max difference "
          f"{np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_direct_radiance_cached_matches(sides, marches):
    cas, tcas, scene, tscene = sides
    o, d, out = marches
    ref = out[False, False][0]
    hit = np.asarray(ref.hit)
    p = (o + d * np.asarray(ref.t)[:, None])[hit]
    with jax.disable_jit():
        n = np.asarray(jtrace.normal(cas, jnp.asarray(p), config=CFG))
        want = np.asarray(jgi.direct_radiance_cached(
            jnp.asarray(p), jnp.asarray(n), scene, cas, CFG))
    got = tgi.direct_radiance_cached(torch.as_tensor(p),
                                     torch.as_tensor(n.copy()), tscene,
                                     tcas, TCFG).numpy()
    print(f"direct_radiance_cached: {len(p)} points, "
          f"{float((want > 0).any(-1).mean()):.3f} lit, max difference "
          f"{np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("mode", range(DebugMode.SDF_DISTANCE,
                                       DebugMode.SDF_CASCADE_ID + 1))
def test_sdf_debug_color_matches(sides, marches, mode):
    cas, tcas, _, _ = sides
    ref = marches[2][False, False][0]
    rec = ttrace.SDFHit(**{f.name: torch.as_tensor(np.array(
        getattr(ref, f.name))) for f in dataclasses.fields(ref)
        if getattr(ref, f.name) is not None})
    want = np.asarray(jgi.sdf_debug_color(mode, ref, cas, CFG))
    got = tgi.sdf_debug_color(mode, rec, tcas, TCFG).numpy()
    assert got.shape == want.shape == (M, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_compact_loop_past_the_budget_as_reference(sides, marches):
    """With a budget the rays exhaust (12 steps), the JAX compact loop
    marches the compacted rays that are still active again in its
    full-width cleanup, up to 2 * max_steps - 8 steps in all, where the
    one-stage loop stops at max_steps; the port's loop does the same,
    ray for ray."""
    cas, tcas, _, _ = sides
    o, d, _ = marches
    with jax.disable_jit():
        plain = jtrace.march(cas, jnp.asarray(o), jnp.asarray(d), 10.0,
                             config=CFG, max_steps=12)
        ref = jtrace.march(cas, jnp.asarray(o), jnp.asarray(d), 10.0,
                           config=CFG, max_steps=12, compact=True)
    got = ttrace.march(tcas, torch.as_tensor(o), torch.as_tensor(d), 10.0,
                       config=TCFG, max_steps=12, compact=True)
    it = np.asarray(ref.iterations)
    print(f"compact loop at 12 steps: {int((it > 12).sum())} of {M} rays "
          f"march past the budget (at most {it.max()} steps); "
          f"{int(np.asarray(ref.hit).sum())} hits against the one-stage "
          f"loop's {int(np.asarray(plain.hit).sum())}")
    assert it.max() == 16 and np.asarray(plain.iterations).max() == 12
    for key in ("hit", "iterations", "cascade", "brick", "t"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(ref, key)),
                                      err_msg=key)
