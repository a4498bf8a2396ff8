"""Port of tools/micro_grouped.py: the grouped-singleton raster step,
which packs G = TC / W tiles (each with <= W templates) into one step.

    python -m vri_tpu_torch.tools.micro_grouped [--device cpu]

On the card it times ``ops.worklist.grouped_step`` for W in 8, 16, 32,
64 and 128, 512, 2048 steps on the tool's seeded inputs (``bench``); with
``--device cpu`` it runs the tool's ``check(W)`` for W in 8, 16, 32: the
plain version against float64 numpy, z within 1e-5 relative and slot ids
exact wherever the block's winner leads its runner-up by more than 1e-6.
The TPU's per-block winner (suffix minimum over rolled lanes, one-hot
extraction by two matrix products) is a walk over each block's W lanes
on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from vri_tpu_torch.ops import worklist
from vri_tpu_torch.tools import card_line, device_of, parser, time_ms

P = 1024            # 8 x 128 pixel tile
TC = 128
NUM_CHUNKS = 2048


def inputs(n_steps: int, device, *, seed: int = 0):
    wc, chunks = worklist.grouped_inputs(n_steps, tc=TC,
                                         num_chunks=NUM_CHUNKS, seed=seed)
    return (torch.as_tensor(wc, device=device),
            torch.as_tensor(chunks, device=device))


def check(w: int) -> int:
    """The tool's reference check of four steps (seed 1) against float64
    numpy; returns the number of tie pixels whose ids were not held."""
    n = 4
    wc, chunks = inputs(n, torch.device("cpu"), seed=1)
    z, s = worklist.grouped_step(wc, chunks, w=w, p=P)
    z, s = z.numpy(), s.numpy()
    ch = chunks.numpy()
    g_count = TC // w
    pix = np.arange(P)
    px = 0.5 + (pix % 128)
    py = 0.5 + (pix // 128)
    ties = 0
    for i in range(n):
        rows = ch[int(wc[i])]
        out = px[:, None] * rows[0][None, :] + py[:, None] * rows[1][None, :] \
            + rows[2][None, :]
        l1, l2, zz = out[:, :TC], out[:, TC:2 * TC], out[:, 2 * TC:]
        ok = (np.minimum(np.minimum(l1, l2), zz) >= 0) & (l1 + l2 <= 1) \
            & (zz <= 1)
        zm = np.where(ok, zz, 2.0)
        for g in range(g_count):
            blk = zm[:, g * w:(g + 1) * w]
            zmin = blk.min(axis=1)
            kwin = blk.argmin(axis=1)
            hit = zmin <= 1.0
            zref = np.where(hit, zmin, 3e38)
            sref = np.where(hit, rows[5][g * w + kwin].astype(np.int32), -1)
            dz = np.abs(z[i, g] - zref) / np.maximum(np.abs(zref), 1e-6)
            assert (dz[hit] < 1e-5).all(), (i, g, dz[hit].max())
            srt = np.sort(blk, axis=1)
            m = hit & (srt[:, 0] < srt[:, 1] - 1e-6 if w > 1 else hit)
            assert (s[i, g][m] == sref[m]).all(), (i, g)
            ties += int((hit & ~m).sum())
    print(f"W={w}: correctness OK ({ties} tie pixels)", flush=True)
    return ties


def bench(w: int, n_steps: int, device, *, iters: int = 10) -> dict:
    wc, chunks = inputs(n_steps, device)
    ms = time_ms(lambda: worklist.grouped_step(wc, chunks, w=w, p=P),
                 iters, device)
    g = TC // w
    print(f"GROUPED W={w:3d} G={g:3d} n_steps={n_steps:5d}: "
          f"{ms:8.3f} ms ({ms / n_steps * 1e3:6.3f} us/step, "
          f"{ms / (n_steps * g) * 1e3:6.3f} us/tile)", flush=True)
    return dict(ms=ms, args=(wc, chunks), kw=dict(w=w, p=P))


def main(argv=None) -> int:
    a = parser(__doc__).parse_args(argv)
    dev = device_of(a.device)
    print(card_line(dev), flush=True)
    if dev.type == "cpu":
        for w in (8, 16, 32):
            check(w)
    else:
        for w in (8, 16, 32, 64):
            for n in (128, 512, 2048):
                bench(w, n, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
