"""Port of tools/micro_attrib.py: attribution of the work-list step's
per-step cost as an additive ladder of walk variants on the card.

    python -m vri_tpu_torch.tools.micro_attrib [--device cpu]
        [--tiles 2025] [--chunks 2048] [--n-work 4096]

Every rung runs ``ops.worklist.template_walk`` (packed key, three-pass
bf16 split) on the tool's seeded inputs; successive deltas attribute one
step to:

  s0  walk + chunk staging + row update (no arithmetic)
  s1  + one pair of exact bf16 products + the constant (the TPU's one
      bf16 matmul pass), minimum over the 3 TC columns
  s2  + the other two pairs (the TPU's three-pass cascade)
  s3  + the coverage test chain
  s4  + packed key and per-pixel minimum (no extraction)
  s5  + the winner's slot id (== production)

and then the lever:

  s6  the K=6 pass: the hi/mid/lo splits shipped as a pre-split bf16
      operand (``worklist.k6_operand``), one six-term FP32 sum.

Stages 0-4 are timing-only (the TPU kernel leaves their slot scratch
uninitialised), so on the CPU only s5 and s6 run.
"""

from __future__ import annotations

from vri_tpu_torch.ops import worklist
from vri_tpu_torch.tools import card_line, device_of, parser, time_ms
from vri_tpu_torch.tools.micro_steps import NUM_CHUNKS, NUM_TILES, inputs

P, TC = 1024, 128
N_WORK = 4096


def call(args, stage: int, *, chunks_k6=None, num_tiles: int = NUM_TILES):
    evaluation = worklist.ATTRIB_STAGES[stage][0]
    return worklist.template_walk(
        *args, num_tiles=num_tiles, p=P, evaluation=evaluation,
        translate=True, packed=True,
        stage=min(stage, worklist.FULL_STAGE), chunks_k6=chunks_k6)


def run(stage: int, device, *, n_work: int = N_WORK, iters: int = 20,
        num_tiles: int = NUM_TILES, num_chunks: int = NUM_CHUNKS) -> dict:
    """Time rung ``stage``; returns its us per step, ms, inputs and
    keywords (None on the CPU for a timing-only rung)."""
    label = worklist.ATTRIB_STAGES[stage][1]
    if device.type != "cuda" and stage < worklist.FULL_STAGE:
        print(f"s{stage} {label:34s} n={n_work}: timing-only, runs on the "
              "card", flush=True)
        return None
    args = inputs(TC, n_work, device, num_tiles=num_tiles,
                  num_chunks=num_chunks)
    kw = dict(num_tiles=num_tiles)
    if stage >= 6:
        kw["chunks_k6"] = worklist.k6_operand(args[3])
    ms = time_ms(lambda: call(args, stage, **kw), iters, device)
    us = ms / n_work * 1e3
    print(f"s{stage} {label:34s} n={n_work}: {ms:8.3f} ms "
          f"({us:5.3f} us/step)", flush=True)
    return dict(us=us, ms=ms, args=args, kw=kw)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--tiles", type=int, default=NUM_TILES)
    ap.add_argument("--chunks", type=int, default=NUM_CHUNKS)
    ap.add_argument("--n-work", type=int, default=N_WORK)
    a = ap.parse_args(argv)
    dev = device_of(a.device)
    print(card_line(dev), flush=True)
    res = {s: run(s, dev, n_work=a.n_work, num_tiles=a.tiles,
                  num_chunks=a.chunks) for s in worklist.ATTRIB_STAGES}
    if any(r is None for r in res.values()):
        return 0
    us = {s: r["us"] for s, r in res.items()}
    print("\ndeltas (us/step):")
    prev = 0.0
    for s in range(6):
        print(f"  {worklist.ATTRIB_STAGES[s][1]:36s}: +{us[s] - prev:6.3f}")
        prev = us[s]
    print(f"\n  production total : {us[5]:6.3f} us/step")
    print(f"  fused K=6 total  : {us[6]:6.3f} us/step "
          f"({us[5] / max(us[6], 1e-9):.2f}x)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
