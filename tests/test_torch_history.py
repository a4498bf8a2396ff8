"""The temporal frame's ``history`` stage on the CPU: one wrapper,
``frame.temporal_history``, which launches ``csrc/temporal.cu`` for CUDA
tensors and runs ``frame.temporal_history_reference`` for CPU tensors.

* The wrapper on CPU tensors is the plain version, bit-equal to the
  stage's eager code as the frame ran it before the stage had a wrapper
  (written out below), on ``tests/test_torch_cuda.py``'s synthetic cases
  (``gi_scale`` 1 and 2, a band, two ghost rows a side, taps off the
  screen and behind the camera, the last column and row, one GI column,
  NaN and inf history rows), with no launch counted.
* ``render_frame_gi_temporal`` and the row-sharded temporal frame
  (``parallel.tiling``, one rank, two ghost rows) both reach the plain
  version through the wrapper, once a frame, and agree bit for bit, as
  the card's one-rank ``nccl`` test holds them there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_cuda import (HISTORY_CASES, _cornell_dynamic,  # noqa: E402
                             _history_case, _same)
from vri_tpu_torch.ops.geometry import norm3  # noqa: E402
from vri_tpu_torch.passes import frame as frame_mod  # noqa: E402


def _eager_history(data, view_proj, eye, position, normal, valid, ind,
                   depth, new_eye, emissive, albedo, direct, full_valid, *,
                   height, width, gi_scale, history_cap, y0, proj_height,
                   halo):
    """The ``history`` stage's eager code as ``render_frame_gi_temporal``
    and ``tiling._temporal_band`` ran it inline."""
    s = gi_scale
    hs, ws = height // s, width // s
    state = frame_mod.TemporalState(data=data, view_proj=view_proj, eye=eye)
    h_ind, h_count = frame_mod._reproject(
        state, position, normal, valid, data.shape[0] // ws - 2 * halo, ws,
        y0=y0, proj_height=proj_height, halo=halo)
    ind_state, count = frame_mod.temporal_blend(ind, h_ind, h_count,
                                                history_cap)
    if s > 1:
        t_s = norm3(position - new_eye[None, :])
        ind_blend = frame_mod._upsample(ind_state, hs, ws, s)
        count_full = frame_mod._upsample(count, hs, ws, s)
    else:
        t_s, ind_blend, count_full = depth, ind_state, count
    new = torch.cat([ind_state, t_s[:, None], normal, count[:, None]], dim=1)
    color = emissive + albedo * (direct + ind_blend)
    color = torch.where(full_valid[:, None], color, 0.0)
    return color, count_full, new


@pytest.mark.parametrize(
    "case", [c for c in HISTORY_CASES if c != "cell1080"])
def test_history_wrapper_on_cpu_is_the_eager_stage(case):
    args, kw = _history_case(case, "cpu")
    launches = frame_mod.temporal_history.launches
    got = frame_mod.temporal_history(*args, **kw)
    want = _eager_history(*args, **kw)
    assert frame_mod.temporal_history.launches == launches
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and _same(g, w), (case, k)
    if case == "nonfinite":
        assert bool(torch.isnan(want[0]).any())


def test_cpu_frames_reach_the_plain_version_through_the_wrapper(
        monkeypatch):
    """Two frames of ``render_frame_gi_temporal`` and of
    ``tiling.render_frame_tiled_temporal`` (``gi_scale`` 2, a one-rank
    mesh, two ghost rows) on the Cornell box at 64^2: each frame calls the
    wrapper once, which runs the plain version (no launch), and the two
    frames' colour, depth, frame count and new history are equal."""
    from vri_tpu_torch.parallel import make_mesh, tiling

    cfg, s, _, fp, cas, _, _ = _cornell_dynamic("cpu")
    res = 64
    ug = torch.rand((1, (res // 2) ** 2, 2),
                    generator=torch.Generator().manual_seed(0))
    calls = []
    wrapper, plain = frame_mod.temporal_history, \
        frame_mod.temporal_history_reference

    def counted(*args, **kw):
        calls.append(kw.get("halo", 0))
        return wrapper(*args, **kw)

    def plain_counted(*args, **kw):
        calls.append("plain")
        return plain(*args, **kw)

    counted.launches = wrapper.launches
    monkeypatch.setattr(frame_mod, "temporal_history", counted)
    monkeypatch.setattr(frame_mod, "temporal_history_reference",
                        plain_counted)
    mesh = make_mesh(device="cpu")
    kw = dict(height=res, width=res, config=cfg, gi_scale=2, uniforms=ug)
    states = [frame_mod.init_temporal(res, res, 2, device="cpu")
              for _ in range(2)]
    for _ in range(2):
        tiled, states[0] = tiling.render_frame_tiled_temporal(
            s, fp, cas, states[0], mesh=mesh, halo_rows=2, **kw)
        single, states[1] = frame_mod.render_frame_gi_temporal(
            s, fp, cas, states[1], use_cache=True, **kw)
        for key in ("color", "depth", "gi_history"):
            assert torch.equal(tiled[key], single[key]), key
        assert torch.equal(states[0].data, states[1].data)
    assert calls == [2, "plain", 0, "plain"] * 2
    assert counted.launches == wrapper.launches
    assert float(np.mean(single["gi_history"].numpy() >= 2.0)) > 0.3
