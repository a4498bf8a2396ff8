"""Ports of the JAX package's work-list micro-benchmarks under ``tools/``.

Each module ports one tool and runs as ``python -m
vri_tpu_torch.tools.<name>``: on ``cuda`` unless given ``--device cpu``,
timed with CUDA events (on the CPU with the host clock, through the
kernels' plain versions).  They print the rows and labels of their source
tools; where a TPU stage has no counterpart on the card, the row says
which scalar arithmetic runs instead.

* ``micro_steps`` (``tools/micro_steps.py``), ``micro_worklist``,
  ``micro_attrib``: the template walk (``ops/worklist.template_walk``);
* ``micro_pass1``: the setup walk (``ops/worklist.setup_walk``);
* ``micro_grouped``: the grouped step (``ops/worklist.grouped_step``);
* ``prof_worklist``: the stages of the sorted raster tier (kernel R).

It also holds what these tools share with ``chip_smoke.py``: the card
line, the CUDA-event timer, the ray sets that hold ``bvh_traverse``
against its plain version (:func:`bvh_ray_sets`) and the work-list chunks
that cover their tiles (:func:`covering_chunks`).
"""

from __future__ import annotations

import argparse
import subprocess
import time


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default): the kernels; cpu: their plain "
                        "versions")
    return p


def device_of(name: str):
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "false); pass --device cpu for the plain versions")
    return torch.device(name)


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; on the
    CPU a note that times are host-clock times of the plain versions."""
    if device.type != "cuda":
        return "CPU: host clock, plain PyTorch versions (no device metric)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def time_ms(fn, iters: int, device) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls after one warm-up
    call: CUDA events on the card, the host clock on the CPU."""
    import torch

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bvh_ray_sets(r, h: int, w: int):
    """The rays that hold ``bvh_traverse`` through renderer ``r``'s stage
    (``chip_smoke.py`` phase 12, ``kernel_turns``): the h x w camera rays
    and 2^18 random rays in the instances' bounds with per-ray t_max.
    Returns {label: (origins, dirs, t_max)}."""
    import numpy as np
    import torch

    from vri_tpu_torch.ops import raygen
    from vri_tpu_torch.passes import frame as frame_mod

    dev = r.device
    scene = r.scene
    fp = frame_mod.FrameParams.from_camera(r.camera, h, device=dev)
    o, d = raygen.camera_rays(fp.inv_view_proj, fp.eye, h, w)
    ni = max(int(scene.num_instances), 1)
    lo = scene.instance_aabb_lo[:ni].min(0).values.cpu().numpy()
    hi = scene.instance_aabb_hi[:ni].max(0).values.cpu().numpy()
    rng = np.random.default_rng(12)
    m = 1 << 18
    dv = rng.normal(size=(m, 3))
    return {
        "camera": (o.reshape(-1, 3).contiguous(),
                   d.reshape(-1, 3).contiguous(),
                   torch.full((h * w,), 3.0e38, device=dev)),
        "random": tuple(torch.as_tensor(a.astype(np.float32), device=dev)
                        for a in (
            rng.uniform(lo, hi, (m, 3)),
            dv / np.linalg.norm(dv, axis=-1, keepdims=True),
            rng.uniform(0.05, float(np.abs(hi - lo).max()), m)))}


def covering_chunks(tiles, *, p: int, tc: int, setup: bool = False,
                    seed: int = 7):
    """One chunk of TC screen triangles around each of ``tiles`` (the
    tools' grid: 15 tiles of 128 x P/128 pixels a row; ``setup``: the
    setup walk's frame, x offset by tile % 15, TC pixels wide), depths
    at a slant, integer slot ids: most pixels covered, many overlaps.
    The tools' own templates are uniform in [0, 1) and cover almost no
    pixel, so these hold the kernels' winner selection as well."""
    import numpy as np

    from vri_tpu_torch.ops import worklist

    rng = np.random.default_rng(seed)
    t = np.repeat(np.asarray(tiles), tc)
    if setup:
        return worklist.setup_rows_from_triangles(
            worklist.triangles_near(rng, t % 15, 0.0, tc, p // tc), tc)
    tri = worklist.triangles_near(rng, (t % 15) * 128,
                                  (t // 15) * (p // 128), 128, p // 128)
    return worklist.templates_from_triangles(
        tri, rng.integers(0, 1 << 20, t.shape[0]), tc)


def grouped_covering(n_steps: int, *, p: int = 1024, tc: int = 128):
    """(wc, chunks) for the grouped step: ``covering_chunks`` around tile
    0, one chunk a step, each constant moved to the tile origin (0, 0) as
    the grouped prep bakes it."""
    import numpy as np

    ch = covering_chunks([0] * n_steps, p=p, tc=tc)
    ch[:, 2] = ch[:, 2] - ch[:, 0] * ch[:, 3] - ch[:, 1] * ch[:, 4]
    return np.arange(n_steps, dtype=np.int32), ch
