"""The port's work-list step (``vri_tpu_torch/ops/worklist.py``) against
the TPU kernels of the micro-benchmarks under ``tools/``.

The tools cannot be imported here: ``micro_pass1.py`` and
``micro_worklist.py`` run their benchmarks at import, and the others
point JAX's compilation cache into the checkout.  So each test parses the
tool with ``ast`` and executes only the ``def``s it needs, with small
constants and a ``pl`` whose ``pallas_call`` runs in interpret mode on the
CPU; ``micro_pass1.make(v)`` returns a jitted scalar, so it runs under
``jax.disable_jit()`` and the shim keeps the ``pallas_call`` outputs.
Both sides get the same numpy inputs at the tools' P and TC with a few
tiles: the tools' own draws (random templates in [0, 1), which barely
cover), and templates built from screen triangles near each step's tile
with integer slot ids.  Only tiles the work list visits are compared: the
TPU kernels never write the others (the port writes the miss values).

Tolerance, and why (``micro_grouped.check``'s rule): XLA:CPU may contract
multiply-adds and sum a dot in another order, so the two sides' fields
may differ by rounding.  A pixel is a *tie* when another candidate (step,
lane) could take the winner's place within 1e-6: its depth within 1e-6
of the winner's (for the packed key: its quantized depth could reach the
winner's), or the winner or such a candidate within 1e-6 of a coverage
edge, or the packed winner's depth within 1e-6 of a quantization step.
Everywhere else the hit mask and the slot id are exact.  z is within
1e-5 relative where both hit, except where the packed key's winner lies
within 1e-6 of a quantization step: there the two quantized depths may
be one step, 2^-(23 - lane_bits(TC)) relative, apart.  Tie counts are
printed and bounded by 1% of the pixels.  The triangles' depth slopes
are those of surfaces seen at a slant: with a steep slope across an
8-row tile, moving the constant to the tile origin makes the field a
difference of terms near 40, and the two sides' rounding of those terms
alone moves z by more than 1e-5 relative.  Defined results only:
``micro_attrib`` stages 0-4 and ``micro_pass1`` v1-v2 are timing-only.
"""

import ast
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from vri_tpu_torch.ops import worklist  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, TC = 1024, 128
EPS = 1e-6
NT = 30                    # tiles 0..29: two rows of 15
# a tile-sorted work list: runs of 3, 1, 2, 1, 2 and 1 steps; tiles 1, 2,
# 4-6, 8-15, 17-21 and 23-28 are never visited
STEP_TILES = np.array([0, 0, 0, 3, 7, 7, 16, 22, 22, 29], np.int32)


class _InterpretPL:
    """``pallas`` with every ``pallas_call`` in interpret mode; keeps the
    outputs of each call in ``outputs``."""

    def __init__(self):
        self.outputs = []

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, *args, **kw):
        kw["interpret"] = True
        fn = pl.pallas_call(*args, **kw)

        def call(*a):
            out = fn(*a)
            self.outputs.append(out)
            return out
        return call


def _tool(name: str, defs, **consts):
    """Execute only the ``def``s named ``defs`` of ``tools/<name>.py`` in a
    namespace with ``consts``; returns the namespace."""
    path = os.path.join(REPO, "tools", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in defs]
    assert {n.name for n in body} == set(defs), name
    ns = dict(jax=jax, jnp=jnp, np=np, pl=_InterpretPL(), pltpu=pltpu,
              functools=functools, **consts)
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns


def _statements(name: str, pick):
    """Source statements of ``tools/<name>.py`` chosen by ``pick(tree)``,
    as one compiled module."""
    path = os.path.join(REPO, "tools", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    return compile(ast.Module(body=pick(tree), type_ignores=[]), path,
                   "exec")


# -- inputs -------------------------------------------------------------------

def _triangles(rng, n, x0, y0, w, h):
    """Up to n / 2 screen triangles (x, y, depth) around the w x h pixel
    box at (x0, y0) (``worklist.triangles_near``), without slivers."""
    tri = worklist.triangles_near(rng, np.full(n, float(x0)), y0, w, h)
    e1, e2 = tri[:, 1, :2] - tri[:, 0, :2], tri[:, 2, :2] - tri[:, 0, :2]
    area = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    return tri[np.abs(area) > 4.0][: n // 2]


def _list(step_chunks):
    wt = STEP_TILES
    return wt, np.asarray(step_chunks, np.int32), worklist.flags(wt)


def template_inputs(kind: str, p: int = P, tc: int = TC, seed: int = 0):
    """(wt, wc, fl, chunks): ``draws`` -- the tools' random templates;
    ``triangles`` -- two chunks of screen triangles near each step's tile
    (a tile's list holds templates that overlap it), integer slot ids."""
    rng = np.random.default_rng(seed)
    if kind == "draws":
        chunks = rng.random((16, 8, 3 * tc), np.float32)
        return _list(rng.integers(0, 16, STEP_TILES.shape[0])) + (chunks,)
    rows = p // worklist.TILE_W
    chunks, wc = [], []
    for t in STEP_TILES:
        x0 = (t % worklist.NUM_TX) * worklist.TILE_W
        tri = _triangles(rng, 2 * tc, x0, (t // worklist.NUM_TX) * rows,
                         worklist.TILE_W, rows)
        sid = rng.integers(0, 1 << 20, tri.shape[0])
        wc.append(len(chunks))
        chunks.append(worklist.templates_from_triangles(tri[:tc], sid[:tc],
                                                        tc)[0])
    return _list(wc) + (np.stack(chunks),)


def setup_inputs(kind: str, seed: int = 0):
    """(wt, wc, fl, chunks (NC, 24, TC)) for ``micro_pass1``'s walk: the
    tool's standard-normal rows, or triangles in its frame (x offset by
    ``tile % 15``, pixels laid out TC wide)."""
    rng = np.random.default_rng(seed)
    if kind == "draws":
        chunks = rng.standard_normal((16, 24, TC)).astype(np.float32)
        return _list(rng.integers(0, 16, STEP_TILES.shape[0])) + (chunks,)
    chunks, wc = [], []
    for t in STEP_TILES:
        tri = _triangles(rng, 2 * TC, t % worklist.NUM_TX, 0, TC, P // TC)
        wc.append(len(chunks))
        chunks.append(worklist.setup_rows_from_triangles(tri[:TC], TC)[0])
    return _list(wc) + (np.stack(chunks),)


def _t(*xs):
    return tuple(torch.as_tensor(np.array(x)) for x in xs)


# -- the comparison rule ------------------------------------------------------

def _quant(z, bits):
    return np.asarray(z, np.float32).view(np.int32) & ~((1 << bits) - 1)


def _ties(fields, z_port, bits):
    """(ties, straddles), each (P,) bool, of one run from its candidates'
    fields (l1, l2, z), each (C, P) float64, and the port's winner depth
    (P,).  A tie: another candidate could take the winner's place within
    EPS, or a contender lies within EPS of a coverage edge.  A straddle:
    the packed winner's depth lies within EPS of a quantization step, so
    the two sides' quantized z may be one step apart (ids unaffected)."""
    l1, l2, z = fields
    mn = np.minimum(np.minimum(l1, l2), z)
    inside = (mn >= EPS) & (l1 + l2 <= 1 - EPS) & (z <= 1 - EPS)
    outside = (mn < -EPS) | (l1 + l2 > 1 + EPS) | (z > 1 + EPS)
    edge = ~inside & ~outside
    hit = z_port <= 1.0
    zw = np.where(hit, z_port, 2.0).astype(np.float64)
    if bits is None:
        near = z <= zw + EPS
        straddle = np.zeros_like(hit)
    else:
        near = _quant(np.clip(z - EPS, 0, 2), bits) \
            <= _quant(np.clip(zw + EPS, 0, 2), bits)
        # the winner's raw depth: the least covering depth of its quantum
        zq = _quant(zw, bits)
        raw = np.where(inside | edge, z, 3.0)
        raw = np.where(_quant(np.clip(raw, 0, 2), bits) == zq, raw,
                       3.0).min(axis=0)
        straddle = hit & (_quant(np.clip(raw - EPS, 0, 2), bits)
                          != _quant(np.clip(raw + EPS, 0, 2), bits))
    contenders = ((inside | edge) & near).sum(axis=0)
    edgy = (edge & near).any(axis=0)
    return (contenders >= 2) | edgy, straddle


def _compare(label, got, want, runs, bits=None):
    """Port (z, slot) against the tool's, on the runs' tiles; ``runs`` is
    a list of (tile, candidate fields).  ``bits``: the packed key's lane
    bits, whose quantized z may differ by one step at a straddle.
    Returns the hit count."""
    zg, sg = (np.asarray(x).reshape(NT, -1) for x in got)
    zw, sw = (np.asarray(x).reshape(NT, -1) for x in want)
    ties = hits = straddles = 0
    step = 2.0 ** -(23 - bits) if bits is not None else 0.0
    for tile, fields in runs:
        tie, straddle = _ties(fields, zg[tile], bits)
        hit_g, hit_w = zg[tile] <= 1.0, zw[tile] <= 1.0
        clean = ~tie
        assert (hit_g == hit_w)[clean].all(), (label, tile)
        assert (sg[tile] == sw[tile])[clean].all(), (label, tile)
        both = hit_g & hit_w
        dz = np.abs(zg[tile] - zw[tile]) / np.maximum(np.abs(zw[tile]), 1e-6)
        assert (dz[both & ~straddle] < 1e-5).all(), (label, tile)
        assert (dz[both & straddle] <= step * 1.0001).all(), (label, tile)
        assert (zg[tile][~hit_g] == worklist.MISS_Z).all()
        assert (sg[tile][~hit_g] == -1).all()
        ties += int(tie.sum())
        straddles += int(straddle.sum())
        hits += int(hit_g.sum())
    npix = len(runs) * zg.shape[1]
    print(f"{label}: {hits} hit pixels of {npix} on visited tiles, "
          f"{ties} ties, {straddles} depths near a quantization step")
    assert ties <= 0.01 * npix, (label, ties)
    return hits


def _visited(wt, fl):
    s, e = worklist.work_runs(torch.as_tensor(fl))
    return [(int(wt[int(b)]), int(a), int(b)) for a, b in zip(s, e)]


def _template_runs(args, *, p, evaluation, translate, k6=None):
    wt, wc, fl, chunks = args
    tc = chunks.shape[2] // 3
    runs = []
    for tile, a, b in _visited(wt, fl):
        out = worklist.template_fields(
            torch.as_tensor(chunks), torch.as_tensor(wc[a:b + 1]),
            torch.as_tensor(wt[a:b + 1]), p=p, evaluation=evaluation,
            translate=translate,
            chunks_k6=None if k6 is None else k6).double().numpy()
        f = out.transpose(0, 2, 1).reshape(-1, 3, tc, p)
        runs.append((tile, tuple(f[:, k].reshape(-1, p) for k in range(3))))
    return runs


def _pallas_walk(kernel, args, *, p, tc, scratch, extra=()):
    wt, wc, fl, chunks = args
    row = pl.BlockSpec((1, 1, p), lambda i, *_: (_[0][i], 0, 0),
                       memory_space=pltpu.VMEM)
    blk = pl.BlockSpec((1, 8, 3 * tc), lambda i, *_: (_[1][i], 0, 0),
                       memory_space=pltpu.VMEM)
    gs = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3, grid=(wt.shape[0],),
        in_specs=[blk] * (1 + len(extra)), out_specs=[row] * 2,
        scratch_shapes=scratch)
    z, s = pl.pallas_call(
        kernel, grid_spec=gs, interpret=True,
        out_shape=[jax.ShapeDtypeStruct((NT, 1, p), jnp.float32),
                   jax.ShapeDtypeStruct((NT, 1, p), jnp.int32)],
    )(*map(jnp.asarray, (wt, wc, fl, chunks) + tuple(extra)))
    return np.asarray(z), np.asarray(s)


# -- T5: micro_steps ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["draws", "triangles"])
@pytest.mark.parametrize("variant,p,tc", [
    ("kernel", 1024, 128), ("kernel_fused", 1024, 128),
    ("kernel_packed", 1024, 128), ("kernel_packed", 2048, 256),
    ("kernel", 2048, 256)])
def test_micro_steps_kernels(variant, p, tc, kind):
    ns = _tool("micro_steps", [variant])
    args = template_inputs(kind, p, tc)
    packed = variant == "kernel_packed"
    scratch = ([pltpu.VMEM((p, 1), jnp.int32), pltpu.VMEM((p, 1), jnp.float32)]
               if packed else [pltpu.VMEM((p, tc), jnp.float32)] * 2)
    want = _pallas_walk(functools.partial(ns[variant], p, tc), args, p=p,
                        tc=tc, scratch=scratch)
    got = worklist.template_walk(*_t(*args), num_tiles=NT, p=p,
                                 evaluation="bf16x2", translate=True,
                                 packed=packed)
    runs = _template_runs(args, p=p, evaluation="bf16x2", translate=True)
    hits = _compare(f"micro_steps.{variant} P={p} TC={tc} {kind}", got,
                    want, runs, worklist.lane_bits(tc) if packed else None)
    if kind == "triangles":
        assert hits > 0.3 * len(runs) * p


# -- T4: micro_worklist -------------------------------------------------------

@pytest.mark.parametrize("kind", ["draws", "triangles"])
@pytest.mark.parametrize("mode", list(worklist.WORKLIST_MODES))
def test_micro_worklist_modes(mode, kind):
    ns = _tool("micro_worklist", ["kernel"], P=P, TC=TC,
               HIGHEST=jax.lax.Precision.HIGHEST)
    args = template_inputs(kind)
    want = _pallas_walk(functools.partial(ns["kernel"], mode), args, p=P,
                        tc=TC, scratch=[pltpu.VMEM((P, TC), jnp.float32)] * 2)
    evaluation, translate = worklist.WORKLIST_MODES[mode]
    got = worklist.template_walk(*_t(*args), num_tiles=NT, p=P,
                                 evaluation=evaluation, translate=translate)
    runs = _template_runs(args, p=P, evaluation=evaluation,
                          translate=translate)
    _compare(f"micro_worklist {mode} {kind}", got, want, runs)


# -- T3: micro_attrib ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["draws", "triangles"])
@pytest.mark.parametrize("stage", [5, 6])
def test_micro_attrib_defined_stages(stage, kind):
    ns = _tool("micro_attrib", ["kernel"], P=P, TC=TC, TILE_W=128,
               NUM_TX=15)
    args = template_inputs(kind)
    k6 = worklist.k6_operand(torch.as_tensor(args[3]))
    extra = (k6.view(torch.int16).numpy().view(jnp.bfloat16),) \
        if stage == 6 else ()
    want = _pallas_walk(functools.partial(ns["kernel"], stage), args, p=P,
                        tc=TC, extra=extra,
                        scratch=[pltpu.VMEM((P, 1), jnp.int32),
                                 pltpu.VMEM((P, 1), jnp.float32)])
    evaluation = worklist.ATTRIB_STAGES[stage][0]
    got = worklist.template_walk(*_t(*args), num_tiles=NT, p=P,
                                 evaluation=evaluation, translate=True,
                                 packed=True,
                                 chunks_k6=k6 if stage == 6 else None)
    runs = _template_runs(args, p=P, evaluation=evaluation, translate=True,
                          k6=k6 if stage == 6 else None)
    _compare(f"micro_attrib s{stage} {kind}", got, want, runs,
             worklist.lane_bits(TC))


def test_timing_only_variants_refuse_the_cpu():
    args = _t(*template_inputs("draws"))
    with pytest.raises(ValueError, match="timing-only"):
        worklist.template_walk(*args, num_tiles=NT, evaluation="bf16x3",
                               packed=True, stage=3)
    sargs = _t(*setup_inputs("draws"))
    with pytest.raises(ValueError, match="timing-only"):
        worklist.setup_walk(*sargs, num_tiles=NT, variant=2)


# -- T1: micro_pass1 ----------------------------------------------------------

def _setup_runs(args):
    wt, wc, fl, chunks = args
    runs = []
    for tile, a, b in _visited(wt, fl):
        f = worklist.setup_fields(torch.as_tensor(chunks),
                                  torch.as_tensor(wc[a:b + 1]),
                                  torch.as_tensor(wt[a:b + 1]), p=P)
        runs.append((tile, tuple(x.double().numpy().transpose(0, 2, 1)
                                 .reshape(-1, P) for x in f)))
    return runs


def _pass1_tool(args, variant):
    wt, wc, fl, chunks = args
    ns = _tool("micro_pass1", ["make"], P=P, TC=TC, NT=NT,
               WCAP=wt.shape[0], wt=jnp.asarray(wt), wc=jnp.asarray(wc),
               fl=jnp.asarray(fl))
    with jax.disable_jit():
        ns["make"](variant)(jnp.asarray(chunks))
    (z, pos), = ns["pl"].outputs
    return np.asarray(z), np.asarray(pos)


@pytest.mark.parametrize("kind", ["draws", "triangles"])
@pytest.mark.parametrize("variant", worklist.PASS1_DEFINED)
def test_micro_pass1_defined_variants(variant, kind):
    args = setup_inputs(kind)
    want = _pass1_tool(args, variant)
    got = worklist.setup_walk(*_t(*args), num_tiles=NT, p=P,
                              variant=variant)
    wt, wc, fl, chunks = args
    if variant == 0:
        for tile, _, _ in _visited(wt, fl):
            assert (got[0][tile] == 0).all() and (want[0][tile] == 0).all()
            assert (got[1][tile] == 0).all() and (want[1][tile] == 0).all()
        return
    runs = _setup_runs(args)
    hits = _compare(f"micro_pass1 v{variant} {kind}", got, want, runs)
    if kind == "triangles":
        assert hits > 0.3 * len(runs) * P
        # the position is the winner's chunk * TC + lane
        pos = got[1][got[1] >= 0]
        assert (pos // TC < chunks.shape[0]).all()


# -- T2: micro_grouped --------------------------------------------------------

GROUPED_DEFS = ["kernel_grouped", "build_inputs", "call_grouped"]


def _grouped_triangles(n, w, seed=0):
    """n steps, each a chunk of TC / W groups of W triangles around one
    tile, constants moved to that tile's origin (as the grouped prep
    bakes them)."""
    rng = np.random.default_rng(seed)
    chunks = []
    for i in range(n):
        tri = _triangles(rng, 2 * TC, 0, 0, worklist.TILE_W,
                         P // worklist.TILE_W)[:TC]
        ch = worklist.templates_from_triangles(
            tri, rng.integers(0, 1 << 20, tri.shape[0]), TC)[0]
        # bake the constant at the tile origin (0, 0): c - a ox - b oy
        ch[2] = ch[2] - ch[0] * ch[3] - ch[1] * ch[4]
        chunks.append(ch)
    return np.arange(n, dtype=np.int32), np.stack(chunks)


@pytest.mark.parametrize("kind", ["draws", "triangles"])
@pytest.mark.parametrize("w", [8, 16, 32, 64])
def test_micro_grouped_step(w, kind):
    ns = _tool("micro_grouped", GROUPED_DEFS, P=P, TC=TC, NUM_CHUNKS=16)
    if kind == "draws":
        wc, chunks = (np.asarray(x) for x in ns["build_inputs"](w, 3))
    else:
        wc, chunks = _grouped_triangles(3, w)
    zt, st = (np.asarray(x) for x in ns["call_grouped"](
        w, wc.shape[0], jnp.asarray(wc), jnp.asarray(chunks),
        interpret=True))
    zg, sg = worklist.grouped_step(*_t(wc, chunks), w=w, p=P)
    g = TC // w
    wct = torch.as_tensor(np.array(wc))
    out = worklist.template_fields(torch.as_tensor(np.array(chunks)), wct,
                                   wct,
                                   p=P, evaluation="bf16x2",
                                   translate=False).double().numpy()
    ties = hits = 0
    for i in range(wc.shape[0]):
        for k in range(g):
            lanes = np.arange(k * w, (k + 1) * w)
            fields = tuple(out[i][:, f * TC + lanes].T for f in range(3))
            tie, _ = _ties(fields, zg[i, k].numpy(), worklist.lane_bits(TC))
            hg, ht = zg[i, k].numpy() <= 1.0, zt[i, k] <= 1.0
            assert (hg == ht)[~tie].all() and \
                (sg[i, k].numpy() == st[i, k])[~tie].all(), (i, k)
            both = hg & ht
            dz = np.abs(zg[i, k].numpy() - zt[i, k]) \
                / np.maximum(np.abs(zt[i, k]), 1e-6)
            assert (dz[both] < 1e-5).all(), (i, k)
            ties += int(tie.sum())
            hits += int(hg.sum())
    print(f"micro_grouped W={w} {kind}: {hits} hits, {ties} ties")
    assert ties <= 0.01 * zg.numel()
    if kind == "triangles":
        assert hits > 0.1 * zg.numel()


def _block_ties(chunks, wc, w):
    """(key ties, exact ties) of the grouped step's block winners: pixels
    (of every step and block) where a covering lane with the winner's key
    quantum has a smaller z than the winner, and where another lane has
    the winner's z exactly."""
    out = worklist.template_fields(torch.as_tensor(chunks),
                                   torch.as_tensor(wc), None, p=P,
                                   evaluation="bf16x2", translate=False)
    zm = worklist._covered_depth(out, TC).numpy()
    mask = ~((1 << worklist.lane_bits(TC)) - 1)
    q = (zm.view(np.int32) & mask).reshape(*zm.shape[:2], TC // w, w)
    zb = zm.reshape(q.shape)
    win = (q | np.arange(w)).argmin(-1)[..., None]
    qw = np.take_along_axis(q, win, -1)
    zw = np.take_along_axis(zb, win, -1)
    hit = zw[..., 0] <= 1.0
    key = ((q == qw) & (zb <= 1.0) & (zb < zw)).any(-1) & hit
    exact = ((zb == zw).sum(-1) >= 2) & hit
    return int(key.sum()), int(exact.sum())


@pytest.mark.parametrize("w", [8, 16, 32, 64])
def test_micro_grouped_step_forced_ties(w):
    """T2 interpreted and the plain version bit-equal, z and slot, at every
    pixel, on templates whose every product and sum is exact
    (``grouped_tie_inputs``), with key ties (the lowest lane of a key
    quantum wins though a later lane's z is smaller) and exact z ties."""
    ns = _tool("micro_grouped", GROUPED_DEFS, P=P, TC=TC, NUM_CHUNKS=16)
    wc, chunks = worklist.grouped_tie_inputs(2, w=w, tc=TC, seed=w)
    zt, st = (np.asarray(x) for x in ns["call_grouped"](
        w, wc.shape[0], jnp.asarray(wc), jnp.asarray(chunks),
        interpret=True))
    zg, sg = (x.numpy() for x in worklist.grouped_step(*_t(wc, chunks),
                                                       w=w, p=P))
    key, exact = _block_ties(chunks, wc, w)
    hits = int((sg >= 0).sum())
    print(f"micro_grouped W={w} forced ties: {hits} hits, {key} key ties "
          f"won by a larger z, {exact} exact z ties")
    assert key > 0 and exact > 0 and hits > 0.1 * sg.size
    assert np.array_equal(zg.view(np.int32), zt.view(np.int32))
    assert np.array_equal(sg, st)


def test_micro_grouped_check_runs_on_cpu(capsys):
    from vri_tpu_torch.tools import micro_grouped

    for w in (8, 32):
        micro_grouped.check(w)
    assert "W=32: correctness OK" in capsys.readouterr().out


# -- the input functions against the tools' own draws -------------------------

def _run_draws(name, **consts):
    """Execute ``run``'s statements of ``tools/<name>.py`` up to its
    ``chunks`` assignment; returns the namespace."""
    def pick(tree):
        fn = next(n for n in tree.body
                  if isinstance(n, ast.FunctionDef) and n.name == "run")
        body = []
        for st in fn.body:
            body.append(st)
            if isinstance(st, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "chunks"
                    for t in st.targets):
                return body
        raise AssertionError(name)
    ns = dict(jnp=jnp, np=np, **consts)
    exec(_statements(name, pick), ns)
    return ns


@pytest.mark.parametrize("tool,tc", [("micro_steps", 128),
                                     ("micro_steps", 256),
                                     ("micro_worklist", 128),
                                     ("micro_attrib", 128)])
def test_steps_inputs_match_the_tools_draws(tool, tc):
    n_work = 300
    consts = dict(NUM_TILES=40, NUM_CHUNKS=24, TC=tc, n_work=n_work)
    if tool == "micro_steps":
        consts.update(P=1024)
    ns = _run_draws(tool, **consts)
    got = worklist.steps_inputs(n_work, tc=tc, num_tiles=40, num_chunks=24)
    for g, key in zip(got, ("wt", "wc", "fl", "chunks")):
        np.testing.assert_array_equal(g, np.asarray(ns[key]))


def test_k6_operand_matches_micro_attrib():
    def pick(tree):
        fn = next(n for n in tree.body
                  if isinstance(n, ast.FunctionDef) and n.name == "run")
        block = next(st for st in fn.body if isinstance(st, ast.If))
        return block.body
    rng = np.random.default_rng(3)
    chunks_np = rng.random((6, 8, 3 * TC), np.float32) * 3 - 1
    ns = dict(jnp=jnp, np=np, pl=pl, pltpu=pltpu, NUM_CHUNKS=6, TC=TC,
              chunks_np=chunks_np, in_specs=[], args=[])
    exec(_statements("micro_attrib", pick), ns)
    got = worklist.k6_operand(torch.as_tensor(chunks_np))
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(ns["chunksb"]).view(np.int16))


def test_pass1_inputs_match_micro_pass1():
    def pick(tree):
        names = [st for st in tree.body
                 if isinstance(st, (ast.Assign, ast.For))]
        first = next(i for i, st in enumerate(names)
                     if isinstance(st, ast.Assign)
                     and getattr(st.targets[0], "id", "") == "rng")
        last = next(i for i, st in enumerate(names)
                    if isinstance(st, ast.Assign)
                    and isinstance(st.targets[0], ast.Tuple)
                    and [t.id for t in st.targets[0].elts]
                    == ["wt", "wc", "fl"])
        return names[first:last + 1]
    ns = dict(jnp=jnp, np=np, P=P, TC=TC, NT=50, WCAP=90, NCHUNKS=70)
    exec(_statements("micro_pass1", pick), ns)
    got = worklist.pass1_inputs(tc=TC, nt=50, wcap=90, nchunks=70)
    for g, key in zip(got, ("wt", "wc", "fl", "chunks")):
        np.testing.assert_array_equal(g, np.asarray(ns[key]))


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_inputs_match_build_inputs(seed):
    ns = _tool("micro_grouped", ["build_inputs"], TC=TC, NUM_CHUNKS=20)
    wc, chunks = ns["build_inputs"](16, 50, seed=seed)
    got = worklist.grouped_inputs(50, tc=TC, num_chunks=20, seed=seed)
    np.testing.assert_array_equal(got[0], np.asarray(wc))
    np.testing.assert_array_equal(got[1], np.asarray(chunks))


def test_templates_from_triangles_are_the_barycentric_fields():
    rng = np.random.default_rng(5)
    tri = _triangles(rng, 40, 100, 10, 128, 8)
    sid = rng.integers(0, 1 << 20, tri.shape[0])
    ch = worklist.templates_from_triangles(tri, sid, 16).astype(np.float64)
    for n in range(tri.shape[0]):
        k, l = divmod(n, 16)
        for corner, want in ((0, (0, 0)), (1, (1, 0)), (2, (0, 1))):
            x, y, z = tri[n, corner]
            vals = [ch[k, 0, f * 16 + l] * (x - ch[k, 3, f * 16 + l])
                    + ch[k, 1, f * 16 + l] * (y - ch[k, 4, f * 16 + l])
                    + ch[k, 2, f * 16 + l] for f in range(3)]
            np.testing.assert_allclose(vals, [*want, z], atol=2e-4)
        assert ch[k, 5, l] == sid[n]
    # padding lanes never cover
    pad = tri.shape[0] % 16
    assert pad == 0 or (ch[-1, 2, pad:16] == -1).all()


def test_work_runs_skip_broken_runs():
    fl = torch.tensor([5, 4, 6, 5, 4, 5, 6, 0, 7, 4], dtype=torch.int32)
    s, e = worklist.work_runs(fl)
    # the run at 3 meets a first flag at 5 before its last flag: dropped;
    # the run at 9 never reaches a last flag: dropped
    assert s.tolist() == [0, 5, 8] and e.tolist() == [2, 6, 8]


def broken_flags(fl):
    """``fl`` of ``STEP_TILES`` with broken runs: tile 0's run loses its
    last flag (step 3's first flag breaks it), step 5 opens a second run
    on tile 7 (breaking the one at step 4), tile 29's run never closes."""
    fl = fl.copy()
    fl[2] &= ~worklist.LAST
    fl[5] |= worklist.FIRST
    fl[9] &= ~worklist.LAST
    return fl


@pytest.mark.parametrize("kind", ["draws", "triangles"])
@pytest.mark.parametrize("walk", ["kernel", "kernel_packed", "pass1"])
def test_broken_runs_match_the_tools(walk, kind):
    """The TPU kernels re-initialise at a first flag and write at a last
    flag, so a run broken before its last flag is never written: the
    port's walks write only the complete runs, and the miss values on the
    tiles no complete run reaches."""
    if walk == "pass1":
        wt, wc, fl, chunks = setup_inputs(kind)
        args = (wt, wc, broken_flags(fl), chunks)
        want = _pass1_tool(args, 3)
        got = worklist.setup_walk(*_t(*args), num_tiles=NT, p=P)
        runs, bits = _setup_runs(args), None
    else:
        wt, wc, fl, chunks = template_inputs(kind)
        args = (wt, wc, broken_flags(fl), chunks)
        packed = walk == "kernel_packed"
        ns = _tool("micro_steps", [walk])
        scratch = ([pltpu.VMEM((P, 1), jnp.int32),
                    pltpu.VMEM((P, 1), jnp.float32)] if packed
                   else [pltpu.VMEM((P, TC), jnp.float32)] * 2)
        want = _pallas_walk(functools.partial(ns[walk], P, TC), args, p=P,
                            tc=TC, scratch=scratch)
        got = worklist.template_walk(*_t(*args), num_tiles=NT, p=P,
                                     evaluation="bf16x2", translate=True,
                                     packed=packed)
        runs = _template_runs(args, p=P, evaluation="bf16x2",
                              translate=True)
        bits = worklist.lane_bits(TC) if packed else None
    assert [t for t, _ in runs] == [3, 7, 16, 22]
    _compare(f"broken runs, {walk} {kind}", got, want, runs, bits)
    for tile in (0, 29):
        assert (got[0][tile] == worklist.MISS_Z).all()
        assert (got[1][tile] == -1).all()


# -- the tool ports on the CPU -----------------------------------------------

@pytest.mark.parametrize("tool,argv", [
    ("micro_steps", ["--tiles", "30", "--chunks", "8", "--n-work", "12"]),
    ("micro_worklist", ["--tiles", "30", "--chunks", "8", "--n-work", "12"]),
    ("micro_attrib", ["--tiles", "30", "--chunks", "8", "--n-work", "12"]),
    ("micro_pass1", ["--tiles", "12", "--wcap", "30", "--chunks", "30"]),
])
def test_tool_ports_run_on_the_cpu(tool, argv, capsys):
    import importlib

    mod = importlib.import_module(f"vri_tpu_torch.tools.{tool}")
    assert mod.main(["--device", "cpu"] + argv) == 0
    out = capsys.readouterr().out
    assert "CPU: host clock" in out and " ms " in out


def test_prof_worklist_stages_equal_the_sorted_raster(capsys):
    """T6's stages, composed on the CPU, give ``rasterize_sorted``'s
    HitRecord; the port prints its rows."""
    from vri_tpu_torch.tools import prof_worklist

    dev = torch.device("cpu")
    scene, world, vp, cs = prof_worklist.load(dev, tess=1, objects=24,
                                              width=256, height=64,
                                              cull=True)
    st = prof_worklist.stages(scene, world, vp, height=64, width=256,
                              cull_sign=cs)
    prep = st["prepare"]()
    hit, z = st["resolve"](prep, st["kernel"](prep))
    full, zf = st["full"]()
    assert float((full.tri >= 0).float().mean()) > 0.3
    for key in ("tri", "t", "u", "v"):
        assert torch.equal(getattr(hit, key), getattr(full, key)), key
    assert torch.equal(z, zf)
    assert prof_worklist.main(["1", "--device", "cpu", "--objects", "24",
                               "--width", "256", "--height", "64",
                               "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert "folded into raster_tiles" in out and "(tile, slot) pairs" in out
