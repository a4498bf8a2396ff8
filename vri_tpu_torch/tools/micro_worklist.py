"""Port of tools/micro_worklist.py: the work-list step's per-step cost
under precision, translation and layout variants.  Synthetic inputs,
fixed work count.

    python -m vri_tpu_torch.tools.micro_worklist [--device cpu]
        [--tiles 2025] [--chunks 2048] [--n-work 4096]

Every mode runs ``ops.worklist.template_walk`` with the per-lane rule.
The card has no matrix-unit precisions, so each row names the scalar
arithmetic it runs: the HIGHEST and default-precision modes are one FP32
pair of products (the default precision is FP32, as the JAX reference
computes it on the CPU), ``full-2pass`` two pairs of exact bf16 products
with FP32 sums, ``vpu-fma`` the same FP32 form as ``full-highest``.  It
runs all six modes (the tool runs its first three) and prints each
beside its plain PyTorch version's time on the same inputs.
"""

from __future__ import annotations

from vri_tpu_torch.ops import worklist
from vri_tpu_torch.tools import card_line, device_of, parser, time_ms
from vri_tpu_torch.tools.micro_steps import NUM_CHUNKS, NUM_TILES, inputs

P = 1024          # 8x128 tile
TC = 128
N_WORK = 4096
ARITHMETIC = {
    "full-highest": "FP32 products, constant at the tile origin",
    "full-default": "FP32 products (the default precision), as "
                    "full-highest",
    "notrans-highest": "FP32 products, constant at the template origin",
    "notrans-default": "FP32 products (the default precision), as "
                       "notrans-highest",
    "full-2pass": "2 pairs of exact bf16 products, FP32 sums",
    "vpu-fma": "FP32 products, as full-highest",
}


def call(args, mode: str, *, num_tiles: int = NUM_TILES,
         plain: bool = False):
    evaluation, translate = worklist.WORKLIST_MODES[mode]
    fn = (worklist.template_walk_reference if plain
          else worklist.template_walk)
    return fn(*args, num_tiles=num_tiles, p=P, evaluation=evaluation,
              translate=translate)


def run(mode: str, device, *, n_work: int = N_WORK, iters: int = 10,
        num_tiles: int = NUM_TILES, num_chunks: int = NUM_CHUNKS) -> dict:
    args = inputs(TC, n_work, device, num_tiles=num_tiles,
                  num_chunks=num_chunks)
    ms = time_ms(lambda: call(args, mode, num_tiles=num_tiles), iters,
                 device)
    plain_ms = time_ms(lambda: call(args, mode, num_tiles=num_tiles,
                                    plain=True), 1, device)
    print(f"{mode:18s} n_work={n_work}: {ms:8.3f} ms "
          f"({ms / n_work * 1e3:5.3f} us/step; plain version "
          f"{plain_ms:.1f} ms) [{ARITHMETIC[mode]}]", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, args=args)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--tiles", type=int, default=NUM_TILES)
    ap.add_argument("--chunks", type=int, default=NUM_CHUNKS)
    ap.add_argument("--n-work", type=int, default=N_WORK)
    a = ap.parse_args(argv)
    dev = device_of(a.device)
    print(card_line(dev), flush=True)
    for m in worklist.WORKLIST_MODES:
        run(m, dev, n_work=a.n_work, num_tiles=a.tiles,
            num_chunks=a.chunks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
