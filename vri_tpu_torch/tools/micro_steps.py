"""Port of tools/micro_steps.py: per-step fixed vs marginal cost of the
work-list step, and shape variants: pixel-tile height (P) and chunk
width (TC); then the packed-key walk.

    python -m vri_tpu_torch.tools.micro_steps [--device cpu]
        [--tiles 2025] [--chunks 2048] [--n-work 2048,4096,8192]

Every row runs ``ops.worklist.template_walk`` (bf16 two-pass products
evaluated as two pairs of exact products with FP32 sums, constant moved
to the tile origin) on the tool's seeded inputs.  The per-lane rows are
the tool's ``kernel``, the PACKED rows its ``kernel_packed``, the FUSED
rows its ``kernel_fused`` (which the tool defines but does not run): on
the card that is the per-lane walk itself, as there is no (P, TC)
scratch for a singleton step to skip.
"""

from __future__ import annotations

import torch

from vri_tpu_torch.ops import worklist
from vri_tpu_torch.tools import card_line, device_of, parser, time_ms

NUM_TILES = 2025
NUM_CHUNKS = 2048
SHAPES = ((1024, 128), (1024, 256), (2048, 128), (2048, 256), (4096, 128))
N_WORK = (2048, 4096, 8192)


def inputs(tc: int, n_work: int, device, *, num_tiles: int = NUM_TILES,
           num_chunks: int = NUM_CHUNKS):
    """The tool's (wt, wc, fl, chunks) on ``device``."""
    return tuple(torch.as_tensor(x, device=device)
                 for x in worklist.steps_inputs(n_work, tc=tc,
                                                num_tiles=num_tiles,
                                                num_chunks=num_chunks))


def call(args, *, p: int, packed: bool, num_tiles: int = NUM_TILES):
    return worklist.template_walk(*args, num_tiles=num_tiles, p=p,
                                  evaluation="bf16x2", translate=True,
                                  packed=packed)


def run(p: int, tc: int, n_work: int, device, *, variant: str = "lane",
        iters: int = 10, num_tiles: int = NUM_TILES,
        num_chunks: int = NUM_CHUNKS) -> dict:
    """Time one row; ``variant`` is "lane" (the tool's ``run``), "fused"
    (``run_fused``) or "packed" (``run_packed``).  Returns the row's ms,
    the inputs and the call's keywords."""
    args = inputs(tc, n_work, device, num_tiles=num_tiles,
                  num_chunks=num_chunks)
    kw = dict(p=p, packed=variant == "packed", num_tiles=num_tiles)
    ms = time_ms(lambda: call(args, **kw), iters, device)
    us = ms / n_work * 1e3
    if variant == "lane":
        print(f"P={p:5d} TC={tc:4d} n_work={n_work:6d}: {ms:8.3f} ms "
              f"({us:5.3f} us/step)", flush=True)
    elif variant == "fused":
        nsing = int((args[2] == 7).sum())
        print(f"FUSED P={p} TC={tc} n_work={n_work} (singletons {nsing}): "
              f"{ms:8.3f} ms ({us:5.3f} us/step; the per-lane walk: no "
              "scratch to skip on the card)", flush=True)
    else:
        print(f"PACKED P={p} TC={tc} n_work={n_work}: {ms:8.3f} ms "
              f"({us:5.3f} us/step)", flush=True)
    return dict(ms=ms, args=args, kw=kw)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--tiles", type=int, default=NUM_TILES)
    ap.add_argument("--chunks", type=int, default=NUM_CHUNKS)
    ap.add_argument("--n-work", default=",".join(map(str, N_WORK)))
    a = ap.parse_args(argv)
    dev = device_of(a.device)
    ns = [int(x) for x in a.n_work.split(",")]
    sizes = dict(num_tiles=a.tiles, num_chunks=a.chunks)
    print(card_line(dev), flush=True)
    for p, tc in SHAPES:
        for n in ns:
            run(p, tc, n, dev, **sizes)
    for variant in ("packed", "fused"):
        for n in ns:
            run(1024, 128, n, dev, variant=variant, **sizes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
