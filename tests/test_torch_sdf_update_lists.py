"""The bounded SDF update's fixed-capacity lists and counts
(``vri_tpu_torch.ops.sdf_build``), on the CPU.

* ``_first`` (the plain update's fixed-capacity list, the JAX package's
  ``nonzero(size=cap)`` with its rest counted) against the set entries
  of the mask: the first ``cap`` set indices in order, the live count
  and the overflow, on masks whose set entries fall under, at and over
  the cap (and an empty mask, a zero cap).  The device pipeline builds
  the same lists in ``csrc/sdf_update.cu`` and is held bit-equal to the
  plain update on the card.
* ``_count_update`` records the cells and bricks it is given, device
  scalars included, under a recording, and ``sdf_update.kernel_path``
  once for an update that ran the device pipeline; the plain update
  records its cells and bricks as before and no ``kernel_path``.
* ``update_cascades`` takes the plain version for CPU tensors.
* The ctypes mirror of the pipeline's argument block lists the fields of
  ``csrc/sdf_update.cu``'s ``UpdateArgs`` in its order and types.

The device pipeline itself is held bit-equal to the plain update on the
card (``tests/test_torch_cuda.py``).
"""

import ctypes
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from vri_tpu_torch import RenderConfig, SDFConfig, scenes  # noqa: E402
from vri_tpu_torch.ops import sdf as sdf_mod  # noqa: E402
from vri_tpu_torch.ops import sdf_build  # noqa: E402
from vri_tpu_torch.runtime import profiler  # noqa: E402

#: tests/test_torch_sdf_update.py's CFG (tests/test_sdf_build.py's)
CFG = SDFConfig(num_cascades=2, cascade_resolution=32, base_voxel_size=0.1,
                max_bricks=8192, truncation_voxels=2.0,
                max_triangles_per_brick=16, update_cell_cap=2048,
                update_brick_cap=8192, update_tri_cap=512)


def _mask(n, n_set, seed):
    rng = np.random.default_rng(seed)
    m = np.zeros(n, bool)
    m[rng.choice(n, size=n_set, replace=False)] = True
    return torch.as_tensor(m)


@pytest.mark.parametrize("n,n_set,cap", [
    (5000, 37, 64),        # under the cap
    (5000, 64, 64),        # at the cap
    (5000, 1500, 64),      # over the cap
    (4096, 4096, 1024),    # every entry set
    (20000, 4097, 4096),   # one past update_tri_cap
    (3, 2, 1),
    (0, 0, 8),             # an empty mask
    (100, 10, 0),          # a zero cap
])
def test_fixed_list_matches_nonzero(n, n_set, cap):
    m = _mask(n, n_set, seed=n + cap)
    idx, over = sdf_build._first(m, cap)
    pos = np.flatnonzero(m.numpy())
    live = min(pos.shape[0], cap)
    assert idx.shape == (live,)
    assert np.array_equal(idx.numpy(), pos[:cap])
    assert over == pos.shape[0] - live


def test_count_update_records_device_scalars():
    @profiler.frame_root
    def frame(i, kernel):
        sdf_build._count_update(torch.tensor(10 + i, dtype=torch.int32),
                                torch.tensor(100 * i, dtype=torch.int64),
                                kernel=kernel)

    sdf_build._count_update(1, 2, kernel=True)       # off: nothing kept
    profiler.start_recording()
    try:
        frame(0, True)
        frame(1, False)
        frame(2, True)
    finally:
        profiler.stop_recording()
    got = [(c.name, c.frame, c.value) for c in profiler.recorded_counts()]
    assert got == [
        ("sdf_update.cells", 0, 10.0), ("sdf_update.bricks", 0, 0.0),
        ("sdf_update.kernel_path", 0, 1.0),
        ("sdf_update.cells", 1, 11.0), ("sdf_update.bricks", 1, 100.0),
        ("sdf_update.cells", 2, 12.0), ("sdf_update.bricks", 2, 200.0),
        ("sdf_update.kernel_path", 2, 1.0)]


@pytest.fixture(scope="module")
def cornell():
    """The Cornell box built at CFG on the CPU, its smallest instance
    moved by (0.15, 0, 0.1): (scene, cascades, state, update inputs)."""
    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.registry import bake_world

    d = RenderDelegate(RenderConfig(width=32, height=32), device="cpu")
    d.populate(scenes.cornell_box())
    s = d.sync()
    world = bake_world(s)
    centers = sdf_mod.default_centers(CFG, np.zeros(3), device="cpu")
    cas, st = sdf_build.build_for_scene(s, world, centers, CFG)
    ni = int(s.num_instances)
    k = int((s.instance_aabb_hi - s.instance_aabb_lo)[:ni].amax(-1).argmin())
    mask = s.tri_instance == k
    vi = s.tri_vertices.long()
    w1 = world.clone()
    w1[torch.unique(vi[mask])] += torch.tensor([0.15, 0.0, 0.1])
    old, new = world[vi[mask]], w1[vi[mask]]
    dlo = torch.stack([old.amin((0, 1)), new.amin((0, 1))])
    dhi = torch.stack([old.amax((0, 1)), new.amax((0, 1))])
    return s, cas, st, (w1, mask, dlo, dhi)


def test_plain_update_counts_as_before(cornell, monkeypatch):
    """The CPU update is the plain version: it records its dirty cells
    and re-emitted bricks, and no ``sdf_update.kernel_path``."""
    s, cas, st, (w1, mask, dlo, dhi) = cornell

    def card_only(*a, **k):
        raise AssertionError("the device pipeline ran on CPU tensors")
    monkeypatch.setattr(sdf_build, "_update_kernel", card_only)
    profiler.start_recording()
    try:
        _, st1, nf = sdf_build.update_for_scene(cas, st, s, w1, mask, dlo,
                                                dhi, CFG)
    finally:
        profiler.stop_recording()
    counts = {c.name: c.value for c in profiler.recorded_counts()}
    assert int(nf) == 0
    assert counts["sdf_update.bricks"] == float(st1.emit_bricks.sum()) > 0
    assert counts["sdf_update.cells"] > 0
    assert "sdf_update.kernel_path" not in counts


def test_update_args_mirror_the_source():
    """``_UPDATE_FIELDS`` names ``UpdateArgs``'s fields in order, each
    8 bytes: a pointer, a long long or a double."""
    path = os.path.join(os.path.dirname(sdf_build.__file__), "..", "csrc",
                        "sdf_update.cu")
    with open(path) as f:
        src = f.read()
    body = re.search(r"struct UpdateArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(.+?)\s*(\w+);", line)
        ctype, name = m.group(1), m.group(2)
        kind = ("p" if "*" in ctype else "d" if ctype == "double"
                else "l" if ctype == "long long" else ctype)
        fields.append(f"{name}:{kind}")
    assert fields == list(sdf_build._UPDATE_FIELDS)
    assert ctypes.sizeof(sdf_build._UpdateArgs) == 8 * len(fields)
