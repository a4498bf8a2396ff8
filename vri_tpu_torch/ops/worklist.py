"""Work-list raster step (counterpart of the TPU kernels under ``tools/``:
``micro_steps.py``, ``micro_worklist.py``, ``micro_attrib.py``,
``micro_pass1.py`` and ``micro_grouped.py``).

The step is the prototype of K1 (``vri_tpu/ops/rasterize.py:_pass1_kernel``).
Its input is a work list of (tile, chunk) steps sorted by tile, each with
flags first = 1, last = 2, live = 4.  A chunk is an (8, 3 TC) float block
of affine templates: rows 0-2 hold the x slope, y slope and constant of
the fields l1, l2 and z (TC lanes each), rows 3-4 the template's origin,
row 5 its slot id.  Every live step evaluates all P pixels of its tile
(128 pixels wide) against all TC lanes; a tile's result is its nearest
covering lane (0 <= z <= 1, l1 >= 0, l2 >= 0, l1 + l2 <= 1) and that
lane's slot id.  The tools vary how the product is rounded, whether the
constant moves to the tile origin, how the winner is accumulated, and the
shape; this module holds one plain PyTorch version and one CUDA kernel
for each of the three functions they compute:

* :func:`template_walk` -- the template walk (``micro_steps``,
  ``micro_worklist``, ``micro_attrib``), kernel ``csrc/worklist.cu``;
* :func:`setup_walk` -- the walk with in-kernel triangle setup from
  (24, TC) vertex rows (``micro_pass1``), kernel ``csrc/worklist.cu``;
* :func:`grouped_step` -- the stateless grouped step that serves TC / W
  tiles at once (``micro_grouped``), kernel ``csrc/worklist_grouped.cu``.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version only for CPU tensors; ``.launches`` counts the launches.
The input functions reproduce each tool's seeded draws
(``np.random.default_rng``, the tool's draw order); the test inputs
(:func:`templates_from_triangles`, :func:`grouped_tie_inputs`) cover
pixels and force the grouped step's ties.

Deliberate differences from the TPU kernels, each kept on both sides:

* Tiles the work list never visits are never written by the TPU kernels
  (interpret mode returns NaN and INT_MIN there).  The port writes the
  miss values there: z = 3e38, slot = -1.
* Evaluation is scalar FP32.  The bf16 splits are part of each mode's
  function (``hi = bf16(a)``, ``lo = bf16(a - hi)``, and ``mid`` for the
  three-pass split); the pixel coordinates k + 0.5 (k < 256) are exact in
  bf16, so every product of a pixel coordinate and a bf16 factor is exact
  in FP32 and the sums are taken in the order the JAX expression writes
  them.  The modes at the platform's default matmul precision
  (``full-default``, ``notrans-default``) are FP32, which is what the
  JAX reference computes on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from vri_tpu_torch import _cuda

FIRST, LAST, LIVE = 1, 2, 4
MISS_Z = 3.0e38
MISS_KEY = 0x40000000            # bit pattern of 2.0f: the key of a miss
TILE_W = 128                     # pixel columns of a tile, in every tool
NUM_TX = 15                      # tiles per row, in every tool

#: ``micro_worklist`` modes -> (eval, translate).  ``vpu-fma`` writes
#: px * a + py * b + ct outside the matrix unit: the FP32 form itself.
WORKLIST_MODES = {
    "full-highest": ("f32", True),
    "full-default": ("f32", True),
    "notrans-highest": ("f32", False),
    "notrans-default": ("f32", False),
    "full-2pass": ("bf16x2", True),
    "vpu-fma": ("f32", True),
}

#: ``micro_attrib`` ladder: stage -> (eval, label).  Stages 0-4 leave the
#: slot scratch uninitialised on the TPU, so they are timing-only here:
#: the kernel runs each stage's work and writes rows that nothing checks.
ATTRIB_STAGES = {
    0: ("bf16x3", "floor (grid+DMA+rows)"),
    1: ("bf16x3", "+1 bf16 matmul + ct"),
    2: ("bf16x3", "+cascade (3-pass, production)"),
    3: ("bf16x3", "+coverage test chain"),
    4: ("bf16x3", "+packed key + reduce + store"),
    5: ("bf16x3", "+extraction (== production)"),
    6: ("k6", "FUSED K=6 cascade (lever)"),
}
FULL_STAGE = 5

#: ``micro_pass1`` variants; 1 and 2 never write their outputs on the
#: TPU, so they are timing-only here.
PASS1_VARIANTS = {0: "floor: DMA+grid only", 1: "+scratch init",
                  2: "+eval", 3: "+finalize"}
PASS1_DEFINED = (0, 3)

#: (evaluation, packed, stage) of each template-walk kernel, in the order
#: of ``vri_worklist_walk``'s mode index: the tools' own modes, then
#: ``micro_attrib``'s timing-only rungs
WALK_KERNELS = (("f32", False, FULL_STAGE), ("bf16x2", False, FULL_STAGE),
                ("bf16x2", True, FULL_STAGE), ("bf16x3", True, FULL_STAGE),
                ("k6", True, FULL_STAGE)) + tuple(
                    ("bf16x3", True, s) for s in range(FULL_STAGE))

#: supported kernel shapes: P a multiple of 128 up to 1024, or 2048 or
#: 4096 (the walks run P / 4 threads, 4 pixels a thread)
_WIDE_P = (2048, 4096)


def lane_bits(tc: int) -> int:
    """Mantissa bits the packed key clears: ``bit_length(TC - 1)``."""
    return (tc - 1).bit_length()


# -- the tools' inputs -------------------------------------------------------

def flags(wt: np.ndarray) -> np.ndarray:
    """first | last | live flags of a tile-sorted work list, as the tools
    compute them."""
    first = np.concatenate([[True], wt[1:] != wt[:-1]])
    last = np.concatenate([wt[1:] != wt[:-1], [True]])
    return (first.astype(np.int32) + 2 * last.astype(np.int32)
            + 4).astype(np.int32)


def steps_inputs(n_work: int, *, tc: int = 128, num_tiles: int = 2025,
                 num_chunks: int = 2048, seed: int = 0):
    """The draws of ``micro_steps.run`` / ``micro_worklist.run`` /
    ``micro_attrib.run``: (wt, wc, fl, chunks) as numpy arrays."""
    rng = np.random.default_rng(seed)
    wt = np.sort(rng.integers(0, num_tiles, n_work)).astype(np.int32)
    wc = rng.integers(0, num_chunks, n_work).astype(np.int32)
    fl = flags(wt)
    chunks = rng.random((num_chunks, 8, 3 * tc), np.float32)
    return wt, wc, fl, chunks


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _splits(x: torch.Tensor):
    """The bf16 hi / mid / lo split of ``x``, as float32: ``hi = bf16(x)``,
    ``mid = bf16(x - hi)``, ``lo = bf16(x - hi - mid)``; the two-pass
    split is (hi, mid)."""
    hi = _bf16(x)
    r = x - hi
    mid = _bf16(r)
    return hi, mid, _bf16(r - mid)


def k6_operand(chunks: torch.Tensor) -> torch.Tensor:
    """``micro_attrib``'s pre-split bf16 operand of stage 6: rows [hi0 hi1
    mid0 mid1 lo0 lo1 0 0] of each chunk's slope rows (NC, 8, 3 TC)."""
    out = torch.zeros(chunks.shape, dtype=torch.bfloat16,
                      device=chunks.device)
    out[:, 0:6] = torch.cat(_splits(chunks[:, 0:2]), 1)
    return out


def pass1_inputs(*, tc: int = 128, nt: int = 2025, wcap: int = 5313,
                 nchunks: int = 3288, seed: int = 0):
    """The draws of ``micro_pass1`` (module level): (wt, wc, fl, chunks);
    about 2 steps a tile, padded to ``wcap`` with flagless steps."""
    rng = np.random.default_rng(seed)
    chunks = rng.standard_normal((nchunks, 24, tc)).astype(np.float32)
    nsub = rng.integers(1, 4, nt)
    cum = np.cumsum(nsub)
    offs = cum - nsub
    wt = np.full(wcap, nt - 1, np.int32)
    wc = np.zeros(wcap, np.int32)
    fl = np.zeros(wcap, np.int32)
    for t in range(nt):
        for k in range(nsub[t]):
            i = offs[t] + k
            if i >= wcap:
                break
            wt[i] = t
            wc[i] = min(t * 2 + k, nchunks - 1)
            fl[i] = (1 if k == 0 else 0) | (2 if k == nsub[t] - 1 else 0) | 4
    return wt, wc, fl, chunks


def grouped_inputs(n_steps: int, *, tc: int = 128, num_chunks: int = 2048,
                   seed: int = 0):
    """The draws of ``micro_grouped.build_inputs``: (wc, chunks) with
    integer slot ids below 2^20 in row 5."""
    rng = np.random.default_rng(seed)
    wc = rng.integers(0, num_chunks, n_steps).astype(np.int32)
    chunks = rng.random((num_chunks, 8, 3 * tc), np.float32).astype(
        np.float32)
    chunks[:, 5] = np.repeat(
        rng.integers(0, 1 << 20, (num_chunks, tc)), 3, axis=0
    ).reshape(num_chunks, 3 * tc).astype(np.float32)
    return wc, chunks


def grouped_tie_inputs(n_steps: int, *, w: int, tc: int = 128,
                       seed: int = 0):
    """(wc, chunks) for the grouped step whose W-lane blocks force ties of
    the packed key.  Lane kinds in a block: *family* lanes share the
    block's depth plane and differ only by a constant d 2^-24 (d < 40), so
    their z differ in the low bits the key clears and, within one key
    quantum, the lowest covering lane wins whatever its d; *copies* repeat
    an earlier lane of the block exactly (equal z: the lane bits decide);
    the rest have planes of their own, some beyond z = 1.  Most lanes
    share the block's l1 and l2 planes, so a block's lanes overlap.
    Every value is dyadic: slopes of at most 12 significant bits (the bf16
    split holds them exactly), and every product and partial sum of the
    bf16x2 evaluation at a pixel of a tile up to 8 rows is exact in
    float32, so no order of evaluation or contraction changes a bit.
    Step i reads chunk i; slot ids are integers below 2^20."""
    rng = np.random.default_rng(seed)
    n = n_steps
    off = np.arange(tc) % w                  # offset of a lane in its block

    def per_block(x):                        # (n, tc / w) -> (n, tc)
        return np.repeat(x, w, axis=1)

    def grid(lo, hi, step, shape):           # uniform on a dyadic grid
        return rng.integers(round(lo / step), round(hi / step),
                            shape) * step

    def cover_planes(shape):                 # (a, b, c) of l1 or l2
        return (grid(-4 / 512, 5 / 512, 2.0 ** -9, shape),
                grid(-8 / 64, 9 / 64, 2.0 ** -6, shape),
                grid(-0.25, 1.0, 2.0 ** -10, shape))

    def depth_plane(shape, c_lo, c_hi):
        return (grid(-2047 * 2.0 ** -20, 2048 * 2.0 ** -20, 2.0 ** -20,
                     shape),
                grid(-2047 * 2.0 ** -18, 2048 * 2.0 ** -18, 2.0 ** -18,
                     shape),
                grid(c_lo, c_hi, 2.0 ** -21, shape))

    family, copy = 0, 1                      # and 2: a plane of its own
    kind = rng.choice(3, (n, tc), p=[0.6, 0.2, 0.2])
    kind[:, off == 0] = family
    shared = rng.random((n, tc)) < np.where(kind == family, 0.8, 0.5)
    fields = []
    for _ in range(2):
        block, own = cover_planes((n, tc // w)), cover_planes((n, tc))
        fields.append([np.where(shared, per_block(b), o)
                       for b, o in zip(block, own)])
    block = depth_plane((n, tc // w), 0.3, 0.65)
    own = depth_plane((n, tc), 0.3, 1.3)
    d = rng.integers(0, 40, (n, tc)) * 2.0 ** -24
    z = [np.where(kind == family, per_block(b), o)
         for b, o in zip(block, own)]
    z[2] = z[2] + np.where(kind == family, d, 0.0)
    fields.append(z)
    # copies, in block order: each repeats an earlier lane of its block
    for j in range(1, w):
        rows, lanes = np.nonzero((kind == copy) & (off == j))
        src = lanes - j + rng.integers(0, j, lanes.shape)
        for f in fields:
            for x in f:
                x[rows, lanes] = x[rows, src]
    chunks = np.zeros((n, 8, 3 * tc), np.float64)
    for fi, f in enumerate(fields):
        for r, x in enumerate(f):
            chunks[:, r, fi * tc:(fi + 1) * tc] = x
    chunks[:, 5] = np.tile(rng.integers(0, 1 << 20, (n, tc)), 3)
    out = chunks.astype(np.float32)
    assert np.array_equal(out, chunks), "a tie template is not float32"
    return np.arange(n, dtype=np.int32), out


def templates_from_triangles(tri: np.ndarray, sid: np.ndarray,
                             tc: int = 128) -> np.ndarray:
    """Chunks (ceil(N / TC), 8, 3 TC) float32 from screen triangles ``tri``
    (N, 3, 3): pixel x, y and depth of corners a, b, c.  Lane l of chunk k
    is triangle k TC + l: l1 and l2 are its barycentric weights of b and
    c, z its depth, each an affine field a (x - ox) + b (y - oy) + c about
    the triangle's bbox minimum (ox, oy), built in float64 and rounded
    once; row 5 holds the integer ``sid``.  Padding lanes never cover."""
    tri = np.asarray(tri, np.float64)
    n = tri.shape[0]
    nc = max(-(-n // tc), 1)
    out = np.zeros((nc * tc, 8, 3), np.float64)
    out[:, 2, 0] = -1.0                       # padding: l1 = -1 everywhere
    o = tri[:, :, :2].min(axis=1)             # (N, 2) origin
    p = tri[:, :, :2] - o[:, None, :]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    inv = 1.0 / det
    # [l1, l2] = M (q - p0) with M the inverse of [e1 e2]
    m = np.stack([np.stack([e2[:, 1], -e2[:, 0]], -1),
                  np.stack([-e1[:, 1], e1[:, 0]], -1)], 1) * inv[:, None,
                                                                  None]
    for f in range(2):
        out[:n, 0, f] = m[:, f, 0]
        out[:n, 1, f] = m[:, f, 1]
        out[:n, 2, f] = -(m[:, f, 0] * p[:, 0, 0] + m[:, f, 1] * p[:, 0, 1])
    dz1 = tri[:, 1, 2] - tri[:, 0, 2]
    dz2 = tri[:, 2, 2] - tri[:, 0, 2]
    for r in range(3):
        out[:n, r, 2] = out[:n, r, 0] * dz1 + out[:n, r, 1] * dz2
    out[:n, 2, 2] += tri[:, 0, 2]
    out[:n, 3, :] = o[:, 0, None]
    out[:n, 4, :] = o[:, 1, None]
    out[:n, 5, :] = np.asarray(sid, np.float64)[:, None]
    # lanes -> (chunk, row, field * TC + lane)
    out = out.reshape(nc, tc, 8, 3).transpose(0, 2, 3, 1)
    return out.reshape(nc, 8, 3 * tc).astype(np.float32)


def triangles_near(rng: np.random.Generator, x0, y0, w: float,
                   h: float) -> np.ndarray:
    """One screen triangle (x, y, depth of corners a, b, c) around each w x
    h pixel box at (x0[i], y0[i]): corners spread over about the box, each
    triangle at a depth in [0.1, 0.9] with corners ~0.01 apart (surfaces
    seen at a slant, as a real stage's are).  Returns (N, 3, 3) float64;
    overlapping triangles cover most pixels of the boxes."""
    x0 = np.asarray(x0, np.float64)
    y0 = np.broadcast_to(np.asarray(y0, np.float64), x0.shape)
    n = x0.shape[0]
    c = np.stack([x0 + rng.uniform(-0.1, 1.1, n) * w,
                  y0 + rng.uniform(-0.2, 1.2, n) * h], -1)
    corners = c[:, None, :] + rng.normal(size=(n, 3, 2)) * [0.35 * w,
                                                             0.6 * h]
    depth = rng.uniform(0.1, 0.9, (n, 1, 1)) \
        + rng.normal(scale=0.01, size=(n, 3, 1))
    return np.concatenate([corners, depth], -1)


def setup_rows_from_triangles(tri: np.ndarray, tc: int = 128) -> np.ndarray:
    """``micro_pass1`` chunks (ceil(N / TC), 24, TC) float32 from triangles
    (N, 3, 3): rows 0-8 are the x, y and depth of corners a, b, c;
    padding lanes carry depth 9, which the setup treats as dead."""
    tri = np.asarray(tri, np.float32)
    n = tri.shape[0]
    nc = max(-(-n // tc), 1)
    out = np.zeros((nc * tc, 24), np.float32)
    out[:, 6] = 9.0
    out[:n, 0:9] = tri.transpose(0, 2, 1).reshape(n, 9)
    return np.ascontiguousarray(out.reshape(nc, tc, 24).transpose(0, 2, 1))


# -- runs of the work list ---------------------------------------------------

def work_runs(fl: torch.Tensor):
    """(start, end) step indices of each tile run: a step with the first
    flag up to the next step with the last flag, when no other first
    flag comes between (the TPU kernels re-initialise there and never
    write the broken run)."""
    n = fl.shape[0]
    idx = torch.arange(n, device=fl.device)
    firsts = idx[(fl & FIRST) != 0]
    lasts = idx[(fl & LAST) != 0]
    if firsts.numel() == 0 or lasts.numel() == 0:
        empty = idx[:0]
        return empty, empty
    j = torch.searchsorted(lasts, firsts)
    has_last = j < lasts.numel()
    end = lasts[j.clamp(max=lasts.numel() - 1)]
    nxt = torch.cat([firsts[1:], idx.new_full((1,), n)])
    ok = has_last & (end < nxt)
    return firsts[ok], end[ok]


# -- plain versions -----------------------------------------------------------

def _pixels(p: int, width: int, dev):
    """Tile-local pixel centers (px, py), each (P, 1)."""
    pix = torch.arange(p, device=dev)
    return ((0.5 + (pix % width).float())[:, None],
            (0.5 + (pix // width).float())[:, None])


def _template_terms(rows, rows_k6, tiles, *, p: int, evaluation: str,
                    translate: bool):
    """Per-step factor pairs [(a, b), ...] and constant c of the field
    sums, each (S, 1, 3 TC), for chunks ``rows`` (S, 8, 3 TC)."""
    a, b, c = rows[:, 0:1], rows[:, 1:2], rows[:, 2:3]
    if translate:
        fx0 = ((tiles % NUM_TX) * TILE_W).float()[:, None, None]
        fy0 = ((tiles // NUM_TX) * (p // TILE_W)).float()[:, None, None]
        c = (a * (fx0 - rows[:, 3:4]) + b * (fy0 - rows[:, 4:5])) + c
    if evaluation == "f32":
        return [(a, b)], c
    if evaluation == "k6":
        k = rows_k6[:, 0:6].float()
        return [(k[:, 2 * j:2 * j + 1], k[:, 2 * j + 1:2 * j + 2])
                for j in range(3)], c
    pairs = list(zip(_splits(a), _splits(b)))
    return pairs[:2] if evaluation == "bf16x2" else pairs, c


def _evaluate(pairs, c, px, py, evaluation: str):
    """out = sum of px a + py b over the pairs, then + c, (S, P, 3 TC):
    one dot a pass ((dot + dot) + dot for the bf16 splits), one six-term
    sum from the left for the K=6 pass."""
    a, b = pairs[0]
    out = px * a + py * b
    for a, b in pairs[1:]:
        if evaluation == "k6":
            out = out + px * a
            out = out + py * b
        else:
            out = out + (px * a + py * b)
    return out + c


def _covered_depth(out: torch.Tensor, tc: int) -> torch.Tensor:
    """z where the lane covers the pixel, 2.0 elsewhere, (S, P, TC)."""
    l1, l2, z = out[..., :tc], out[..., tc:2 * tc], out[..., 2 * tc:]
    ok = ((torch.minimum(torch.minimum(l1, l2), z) >= 0.0)
          & (l1 + l2 <= 1.0) & (z <= 1.0))
    return torch.where(ok, z, 2.0)


def template_fields(chunks, wc, wt, *, p: int, evaluation: str,
                    translate: bool, chunks_k6=None):
    """The evaluated fields (S, P, 3 TC) of steps (wt, wc), as every
    template walk computes them (the tests read them to find the pixels
    whose winner is decided by rounding); ``wt`` is read only with
    ``translate``."""
    px, py = _pixels(p, TILE_W, chunks.device)
    rows = chunks[wc.long()]
    k6 = chunks_k6[wc.long()] if chunks_k6 is not None else None
    pairs, c = _template_terms(rows, k6, wt, p=p, evaluation=evaluation,
                               translate=translate)
    return _evaluate(pairs, c, px, py, evaluation)


def _batches(steps: torch.Tensor, per_step: int):
    """Slices of ``steps`` that bound the (S, P, 3 TC) temporaries."""
    size = max(1, (1 << 24) // max(per_step, 1))
    for s0 in range(0, steps.shape[0], size):
        yield steps[s0:s0 + size]


def walk_steps(starts, ends, fl):
    """Indices of the live steps inside the runs."""
    n = fl.shape[0]
    inside = torch.zeros(n + 1, dtype=torch.int32, device=fl.device)
    inside.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
    inside.index_add_(0, ends + 1,
                      -torch.ones_like(ends, dtype=torch.int32))
    inside = torch.cumsum(inside[:n], 0) > 0
    return torch.nonzero(inside & ((fl & LIVE) != 0)).flatten()


def _combine(starts, ends, fl, step_best, packed: bool, tc: int):
    """Per-run winners from per-step winners, walking each run in order:
    lane mode keeps the minimum of (z, lane, step) (``z < bz`` or equal z
    at a lower lane), packed mode the minimum key (strict ``<``)."""
    r = starts.shape[0]
    p = step_best[0].shape[1]
    dev = fl.device
    if packed:
        best = torch.full((r, p), MISS_KEY, dtype=torch.int32, device=dev)
    else:
        best = torch.full((r, p), 2.0, device=dev)
        blane = torch.full((r, p), tc, dtype=torch.int64, device=dev)
    bsid = torch.zeros((r, p), device=dev)
    maxlen = int((ends - starts).max()) + 1 if r else 0
    n = fl.shape[0]
    for k in range(maxlen):
        i = starts + k
        act = (i <= ends) & ((fl[i.clamp(max=n - 1)] & LIVE) != 0)
        i = i.clamp(max=n - 1)
        if packed:
            key, sid = step_best[0][i], step_best[1][i]
            upd = act[:, None] & (key < best)
            best = torch.where(upd, key, best)
        else:
            z, lane, sid = (x[i] for x in step_best)
            upd = act[:, None] & ((z < best) | ((z == best)
                                                & (lane < blane)))
            best = torch.where(upd, z, best)
            blane = torch.where(upd, lane, blane)
        bsid = torch.where(upd, sid, bsid)
    return best, bsid


def _finalize(best, bsid, packed: bool, tc: int):
    if packed:
        mask = ~((1 << lane_bits(tc)) - 1)
        z = (best & mask).view(torch.float32)
    else:
        z = best
    hit = z <= 1.0
    return (torch.where(hit, z, MISS_Z),
            torch.where(hit, bsid.to(torch.int32), -1))


def _rows_out(wt, ends, z, slot, num_tiles: int, p: int):
    """(num_tiles, P) rows: each run's at its last step's tile, the miss
    values on tiles no run writes."""
    dev = wt.device
    z_out = torch.full((num_tiles, p), MISS_Z, device=dev)
    s_out = torch.full((num_tiles, p), -1, dtype=torch.int32, device=dev)
    tiles = wt[ends].long()
    z_out[tiles] = z
    s_out[tiles] = slot
    return z_out, s_out


def template_walk_reference(wt, wc, fl, chunks, *, num_tiles: int,
                            p: int = 1024, evaluation: str = "bf16x2",
                            translate: bool = True, packed: bool = False,
                            chunks_k6=None):
    """Plain PyTorch version of the template walk.  Per tile run, the
    winner over its live steps of the nearest covering lane: with
    ``packed`` the minimum key (z bits with ``lane_bits(TC)`` low bits
    cleared) | lane, returning the quantized z (``micro_steps.
    kernel_packed``, ``micro_attrib`` stages 5-6); else the minimum of
    (z, lane, step), the per-lane scratch's lowest-lane finalize
    (``micro_steps.kernel`` / ``kernel_fused``, ``micro_worklist``).
    Returns (z, slot), each (num_tiles, P)."""
    dev = chunks.device
    tc = chunks.shape[2] // 3
    n = wt.shape[0]
    starts, ends = work_runs(fl)
    steps = walk_steps(starts, ends, fl)
    lane = torch.arange(tc, device=dev, dtype=torch.int32)
    mask = ~((1 << lane_bits(tc)) - 1)
    if packed:
        step_best = [torch.full((n, p), MISS_KEY, dtype=torch.int32,
                                device=dev),
                     torch.zeros((n, p), device=dev)]
    else:
        step_best = [torch.full((n, p), 2.0, device=dev),
                     torch.full((n, p), tc, dtype=torch.int64, device=dev),
                     torch.zeros((n, p), device=dev)]
    for s in _batches(steps, p * 3 * tc):
        out = template_fields(chunks, wc[s], wt[s], p=p,
                              evaluation=evaluation, translate=translate,
                              chunks_k6=chunks_k6)
        zm = _covered_depth(out, tc)
        sid_row = chunks[wc[s].long(), 5, :tc]
        if packed:
            key = (zm.view(torch.int32) & mask) | lane
            row = key.min(dim=-1).values
            win = (row & ~mask).long()
            step_best[0][s] = row
            step_best[1][s] = torch.gather(sid_row, 1, win)
        else:
            zmin = zm.min(dim=-1).values
            win = torch.where(zm == zmin[..., None], lane,
                              tc).min(dim=-1).values.long()
            step_best[0][s] = zmin
            step_best[1][s] = win
            step_best[2][s] = torch.gather(sid_row, 1, win)
    best, bsid = _combine(starts, ends, fl, step_best, packed, tc)
    z, slot = _finalize(best, bsid, packed, tc)
    return _rows_out(wt, ends, z, slot, num_tiles, p)


def _setup_terms(rows, tiles):
    """``micro_pass1``'s per-lane triangle setup, in its operation order:
    rows (S, 24, TC) -> nine (S, 1, TC) coefficients (ka1, kb1, kc1, ka2,
    kb2, kc2, kaz, kbz, kcz)."""
    fx0 = (tiles % NUM_TX).float()[:, None, None]
    r = rows[:, :, None, :]
    ax, bx, cx = r[:, 0] - fx0, r[:, 1] - fx0, r[:, 2] - fx0
    ay, by, cy = r[:, 3], r[:, 4], r[:, 5]
    az, bz, cz = r[:, 6], r[:, 7], r[:, 8]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    dead = (az >= 9.0) | (torch.abs(area) <= 1e-12)
    inv = torch.where(dead, 0.0, 1.0 / torch.where(dead, 1.0, area))
    ka1 = -(ay - cy) * inv
    kb1 = (ax - cx) * inv
    kc1 = (cx * (ay - cy) - cy * (ax - cx)) * inv
    ka2 = -(by - ay) * inv
    kb2 = (bx - ax) * inv
    kc2 = (ax * (by - ay) - ay * (bx - ax)) * inv
    dz1, dz2 = bz - az, cz - az
    kaz = ka1 * dz1 + ka2 * dz2
    kbz = kb1 * dz1 + kb2 * dz2
    kcz = az + kc1 * dz1 + kc2 * dz2
    return ka1, kb1, kc1, ka2, kb2, kc2, kaz, kbz, kcz


def setup_fields(chunks, wc, wt, *, p: int):
    """(l1, l2, z), each (S, P, TC), of steps (wt, wc) of the setup walk;
    pixels are laid out TC wide (``micro_pass1``)."""
    tc = chunks.shape[2]
    px, py = _pixels(p, tc, chunks.device)
    k = _setup_terms(chunks[wc.long()], wt)
    return tuple((px * k[3 * f] + py * k[3 * f + 1]) + k[3 * f + 2]
                 for f in range(3))


def setup_walk_reference(wt, wc, fl, chunks, *, num_tiles: int,
                         p: int = 1024, variant: int = 3):
    """Plain PyTorch version of the setup walk (``micro_pass1``).  Variant
    3: per tile run the minimum of (z, lane, step) over the covering
    lanes, with the position carried as float32 wc * TC + lane; returns
    (z, pos), each (num_tiles, P).  Variant 0 writes zero rows on the
    runs' tiles.  The quirks of the tool are kept: the tile's x origin is
    ``tile % 15`` (no * 128) and pixels are laid out TC wide."""
    if variant not in PASS1_DEFINED:
        raise ValueError(f"setup walk variant {variant} is timing-only "
                         "(no defined result); it runs only on the card")
    dev = chunks.device
    tc = chunks.shape[2]
    n = wt.shape[0]
    starts, ends = work_runs(fl)
    if variant == 0:
        zeros = torch.zeros((starts.shape[0], p), device=dev)
        z_out, s_out = _rows_out(wt, ends, zeros, zeros.int(), num_tiles, p)
        return z_out, s_out
    steps = walk_steps(starts, ends, fl)
    lane = torch.arange(tc, device=dev, dtype=torch.int32)
    step_best = [torch.full((n, p), 2.0, device=dev),
                 torch.full((n, p), tc, dtype=torch.int64, device=dev),
                 torch.zeros((n, p), device=dev)]
    for s in _batches(steps, p * 3 * tc):
        zm = _covered_depth(torch.cat(setup_fields(chunks, wc[s], wt[s],
                                                   p=p), -1), tc)
        zmin = zm.min(dim=-1).values
        win = torch.where(zm == zmin[..., None], lane,
                          tc).min(dim=-1).values
        step_best[0][s] = zmin
        step_best[1][s] = win.long()
        step_best[2][s] = (wc[s] * tc).float()[:, None] + win.float()
    best, bpos = _combine(starts, ends, fl, step_best, False, tc)
    hit = best <= 1.0
    z = torch.where(hit, best, MISS_Z)
    pos = torch.where(hit, bpos, -1.0).to(torch.int32)
    return _rows_out(wt, ends, z, pos, num_tiles, p)


def grouped_step_reference(wc, chunks, *, w: int, p: int = 1024):
    """Plain PyTorch version of the grouped step (``micro_grouped.
    kernel_grouped``).  Each step evaluates its chunk (constant term
    already at the tile origin, bf16 two-pass products) at the P pixels
    of one tile and, per W-lane block g, keeps the block's minimum packed
    key (z bits with ``lane_bits(TC)`` low bits cleared) | lane; the
    output is that lane's unquantized z and slot.  Returns (z, slot),
    each (n, TC / W, P)."""
    dev = chunks.device
    tc = chunks.shape[2] // 3
    g = tc // w
    n = wc.shape[0]
    lane = torch.arange(tc, device=dev, dtype=torch.int32)
    mask = ~((1 << lane_bits(tc)) - 1)
    z_out = torch.empty((n, g, p), device=dev)
    s_out = torch.empty((n, g, p), dtype=torch.int32, device=dev)
    for s in _batches(torch.arange(n, device=dev), p * 3 * tc):
        out = template_fields(chunks, wc[s], None, p=p,
                              evaluation="bf16x2", translate=False)
        zm = _covered_depth(out, tc)
        key = (zm.view(torch.int32) & mask) | lane
        kmin = key.view(s.shape[0], p, g, w).min(dim=-1).values
        win = (kmin & ~mask).long()
        zg = torch.gather(zm, 2, win)
        sid = chunks[wc[s].long(), 5, :tc][:, None, :].expand(-1, p, -1)
        sg = torch.gather(sid, 2, win)
        hit = zg <= 1.0
        z_out[s] = torch.where(hit, zg, MISS_Z).permute(0, 2, 1)
        s_out[s] = torch.where(hit, sg.to(torch.int32), -1).permute(0, 2, 1)
    return z_out, s_out


# -- wrappers -----------------------------------------------------------------

def _on_cpu(name: str, tensors: dict) -> bool:
    """True for CPU inputs (plain version); False for CUDA inputs on one
    device (kernel); raises on anything else."""
    xs = list(tensors.values())
    if all(x.device.type == "cpu" for x in xs):
        return True
    if not all(x.is_cuda and x.device == xs[0].device for x in xs):
        raise ValueError(f"{name}: inputs must all be on one CUDA device "
                         "(or all on the CPU)")
    return False


def _check_list(name, wt, wc, fl, chunks, rows: int, p: int):
    for arg, x in (("wt", wt), ("wc", wc), ("fl", fl)):
        if x.dtype != torch.int32 or x.dim() != 1 \
                or x.shape[0] != wt.shape[0]:
            raise ValueError(f"{name}: {arg} must be int32 (n_work,)")
    if chunks.dtype != torch.float32 or chunks.dim() != 3 \
            or chunks.shape[1] != rows:
        raise ValueError(f"{name}: chunks must be (NC, {rows}, width) "
                         f"float32, got {tuple(chunks.shape)} "
                         f"{chunks.dtype}")
    if not (p % TILE_W == 0 and TILE_W <= p <= 1024 or p in _WIDE_P):
        raise ValueError(f"{name}: P = {p} must be a multiple of {TILE_W} "
                         f"up to 1024, or one of {_WIDE_P}")


def template_walk(wt: torch.Tensor, wc: torch.Tensor, fl: torch.Tensor,
                  chunks: torch.Tensor, *, num_tiles: int, p: int = 1024,
                  evaluation: str = "bf16x2", translate: bool = True,
                  packed: bool = False, stage: int = FULL_STAGE,
                  chunks_k6: torch.Tensor | None = None):
    """Template walk wrapper (see :func:`template_walk_reference`): CUDA
    tensors launch ``csrc/worklist.cu`` (one block per step, walking the
    tile run that starts there; P / 4 threads, 4 pixels a thread), with
    no host synchronization (two output fills and one launch); CPU
    tensors run the plain version.  ``stage`` < 5 selects a timing-only
    rung of ``micro_attrib``'s ladder (packed, bf16x3), which runs only
    on the card.  Returns (z, slot), each (num_tiles, P)."""
    name = "template_walk"
    _check_list(name, wt, wc, fl, chunks, 8, p)
    tc = chunks.shape[2] // 3
    if (evaluation == "k6") != (chunks_k6 is not None):
        raise ValueError(f"{name}: chunks_k6 goes with evaluation 'k6'")
    if chunks_k6 is not None and (chunks_k6.dtype != torch.bfloat16
                                  or chunks_k6.shape != chunks.shape):
        raise ValueError(f"{name}: chunks_k6 must be bf16 like chunks")
    if (evaluation, packed, stage) not in WALK_KERNELS:
        raise ValueError(f"{name}: no kernel for evaluation {evaluation!r}, "
                         f"packed={packed}, stage {stage} (the ladder's "
                         "partial stages are packed bf16x3 walks)")
    tensors = dict(wt=wt, wc=wc, fl=fl, chunks=chunks)
    if chunks_k6 is not None:
        tensors["chunks_k6"] = chunks_k6
    if _on_cpu(name, tensors):
        if stage != FULL_STAGE:
            raise ValueError(f"{name}: stage {stage} is timing-only (no "
                             "defined result); it runs only on the card")
        return template_walk_reference(
            wt, wc, fl, chunks, num_tiles=num_tiles, p=p,
            evaluation=evaluation, translate=translate, packed=packed,
            chunks_k6=chunks_k6)
    wt, wc, fl, chunks = (x.contiguous() for x in (wt, wc, fl, chunks))
    k6 = chunks_k6.contiguous() if chunks_k6 is not None else None
    z = torch.full((num_tiles, p), MISS_Z, device=chunks.device)
    slot = torch.full((num_tiles, p), -1, dtype=torch.int32,
                      device=chunks.device)
    code = _cuda.library().vri_worklist_walk(
        wt.data_ptr(), wc.data_ptr(), fl.data_ptr(), wt.shape[0],
        chunks.data_ptr(), k6.data_ptr() if k6 is not None else None, p, tc,
        WALK_KERNELS.index((evaluation, packed, stage)), int(translate),
        z.data_ptr(), slot.data_ptr(), _cuda.stream_ptr(chunks))
    _cuda.check(code, name)
    template_walk.launches += 1
    return z, slot


template_walk.launches = 0


def setup_walk(wt: torch.Tensor, wc: torch.Tensor, fl: torch.Tensor,
               chunks: torch.Tensor, *, num_tiles: int, p: int = 1024,
               variant: int = 3):
    """Setup walk wrapper (see :func:`setup_walk_reference`): CUDA tensors
    launch ``csrc/worklist.cu`` (one block per step, as the template
    walk); CPU tensors run the plain version.  Variants 1 and 2 are
    timing-only (card only).  Returns (z, pos), each (num_tiles, P)."""
    name = "setup_walk"
    _check_list(name, wt, wc, fl, chunks, 24, p)
    tc = chunks.shape[2]
    if variant not in PASS1_VARIANTS:
        raise ValueError(f"{name}: unknown variant {variant}")
    if p % tc or tc > 1024:
        raise ValueError(f"{name}: P must be a multiple of TC <= 1024")
    if _on_cpu(name, dict(wt=wt, wc=wc, fl=fl, chunks=chunks)):
        return setup_walk_reference(wt, wc, fl, chunks, num_tiles=num_tiles,
                                    p=p, variant=variant)
    wt, wc, fl, chunks = (x.contiguous() for x in (wt, wc, fl, chunks))
    z = torch.full((num_tiles, p), MISS_Z, device=chunks.device)
    pos = torch.full((num_tiles, p), -1, dtype=torch.int32,
                     device=chunks.device)
    code = _cuda.library().vri_worklist_setup(
        wt.data_ptr(), wc.data_ptr(), fl.data_ptr(), wt.shape[0],
        chunks.data_ptr(), p, tc, variant, z.data_ptr(), pos.data_ptr(),
        _cuda.stream_ptr(chunks))
    _cuda.check(code, name)
    setup_walk.launches += 1
    return z, pos


setup_walk.launches = 0


def grouped_step(wc: torch.Tensor, chunks: torch.Tensor, *, w: int,
                 p: int = 1024):
    """Grouped step wrapper (see :func:`grouped_step_reference`): CUDA
    tensors launch ``csrc/worklist_grouped.cu`` (one block per step; P / 4
    threads, 4 pixels a thread, as the walks); CPU tensors run the plain
    version.  Returns (z, slot), each (n, TC / W, P)."""
    name = "grouped_step"
    if wc.dtype != torch.int32 or wc.dim() != 1:
        raise ValueError(f"{name}: wc must be int32 (n,)")
    if chunks.dtype != torch.float32 or chunks.dim() != 3 \
            or chunks.shape[1] != 8:
        raise ValueError(f"{name}: chunks must be (NC, 8, 3 TC) float32")
    tc = chunks.shape[2] // 3
    if w < 1 or tc % w:
        raise ValueError(f"{name}: W = {w} must divide TC = {tc}")
    if p % TILE_W or not TILE_W <= p <= 1024:
        raise ValueError(f"{name}: P = {p} must be a multiple of {TILE_W} "
                         "up to 1024")
    if _on_cpu(name, dict(wc=wc, chunks=chunks)):
        return grouped_step_reference(wc, chunks, w=w, p=p)
    wc, chunks = wc.contiguous(), chunks.contiguous()
    n = wc.shape[0]
    z = torch.empty((n, tc // w, p), device=chunks.device)
    slot = torch.empty((n, tc // w, p), dtype=torch.int32,
                       device=chunks.device)
    code = _cuda.library().vri_worklist_grouped(
        wc.data_ptr(), n, chunks.data_ptr(), p, tc, w, z.data_ptr(),
        slot.data_ptr(), _cuda.stream_ptr(chunks))
    _cuda.check(code, name)
    grouped_step.launches += 1
    return z, slot


grouped_step.launches = 0
