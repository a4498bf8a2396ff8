"""Port of tools/micro_pass1.py: the pass-1 work-list walk with in-kernel
triangle setup, split into walk and staging floor, scratch init, eval and
finalize, at the 49k-scene work-list shape.

    python -m vri_tpu_torch.tools.micro_pass1 [--device cpu]
        [--tiles 2025] [--wcap 5313] [--chunks 3288]

Every row runs ``ops.worklist.setup_walk`` on the tool's seeded inputs
(about 2.2 steps a tile).  On the card there is no per-lane scratch: v1's
"scratch init" initialises one scalar best a pixel, so v1 measures about
what v0 does.  Variants 1 and 2 write nothing (as on the TPU) and are
timing-only, so on the CPU only v0 and v3 run.
"""

from __future__ import annotations

import torch

from vri_tpu_torch.ops import worklist
from vri_tpu_torch.tools import card_line, device_of, parser, time_ms

P, TC = 1024, 128
NT = 2025
WCAP = 5313
NCHUNKS = 3288


def inputs(device, *, nt: int = NT, wcap: int = WCAP,
           nchunks: int = NCHUNKS):
    return tuple(torch.as_tensor(x, device=device)
                 for x in worklist.pass1_inputs(tc=TC, nt=nt, wcap=wcap,
                                                nchunks=nchunks))


def call(args, variant: int, *, nt: int = NT):
    return worklist.setup_walk(*args, num_tiles=nt, p=P, variant=variant)


def run(variant: int, device, *, iters: int = 20, nt: int = NT,
        wcap: int = WCAP, nchunks: int = NCHUNKS) -> dict:
    label = worklist.PASS1_VARIANTS[variant]
    if device.type != "cuda" and variant not in worklist.PASS1_DEFINED:
        print(f"v{variant} {label:24s}: timing-only, runs on the card",
              flush=True)
        return None
    args = inputs(device, nt=nt, wcap=wcap, nchunks=nchunks)
    ms = time_ms(lambda: call(args, variant, nt=nt), iters, device)
    print(f"v{variant} {label:24s}: {ms:8.3f} ms "
          f"({ms * 1e3 / wcap:.3f} us/step)", flush=True)
    return dict(ms=ms, args=args, kw=dict(nt=nt))


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--tiles", type=int, default=NT)
    ap.add_argument("--wcap", type=int, default=WCAP)
    ap.add_argument("--chunks", type=int, default=NCHUNKS)
    a = ap.parse_args(argv)
    dev = device_of(a.device)
    print(card_line(dev), flush=True)
    for v in worklist.PASS1_VARIANTS:
        run(v, dev, nt=a.tiles, wcap=a.wcap, nchunks=a.chunks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
