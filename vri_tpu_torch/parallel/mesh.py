"""Device mesh and collectives over ``torch.distributed`` (counterpart of
``vri_tpu/parallel/mesh.py``).

One process per device, as ``torch.distributed.run`` starts them: a
process reads ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``LOCAL_WORLD_SIZE`` and joins the process group; a process started
without them is a mesh of one rank with no process group, whose
collectives are local.  The JAX package's ``shard_map`` body becomes the
code every rank runs, its ``axis_name`` a :class:`MeshAxis`, and its
collectives the plain functions below (:func:`psum`, :func:`all_gather`,
:func:`ppermute`, :func:`axis_index`, :func:`broadcast`).

Backends: ``nccl`` when every rank has its own card (a rank takes
``cuda:LOCAL_RANK``); ``gloo`` only when the caller asks for it -- the CPU,
or ranks that share one card.  Gloo cannot move CUDA tensors, so on a
``gloo`` mesh the collectives copy a CUDA tensor to the host and back;
nowhere else.  An ``nccl`` mesh whose ranks would share a card is refused,
never turned into a ``gloo`` one.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh: axis names and sizes, its coordinates
    (host-major for a 2-D mesh), its device and backend, and one process
    group per axis (None on a one-rank mesh)."""

    axis_names: tuple
    shape: tuple
    coords: tuple
    device: torch.device
    backend: Optional[str]
    groups: tuple

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def rank(self) -> int:
        """Flattened (row-major) position: the rank's band index."""
        return int(np.ravel_multi_index(self.coords, self.shape))

    def axis(self, names=None) -> "MeshAxis":
        """The axis ``names`` (one name, or a tuple of names; None for the
        whole mesh).  A tuple of every axis spans the whole mesh."""
        if names is None:
            names = self.axis_names
        if isinstance(names, str):
            names = (names,)
        names = tuple(names)
        if names == self.axis_names:
            group = dist.group.WORLD if self.backend else None
            return MeshAxis(self, names, self.size, self.rank, group)
        if len(names) != 1 or names[0] not in self.axis_names:
            raise ValueError(f"no mesh axis {names} in {self.axis_names}")
        k = self.axis_names.index(names[0])
        return MeshAxis(self, names, self.shape[k], self.coords[k],
                        self.groups[k])


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of a mesh (or the whole mesh): its size, this rank's index
    along it and its process group (None without one)."""

    mesh: Mesh
    names: tuple
    size: int
    index: int
    group: object

    def global_rank(self, i: int) -> int:
        """Global rank of position ``i`` along this axis (this rank's other
        coordinates held)."""
        if self.names == self.mesh.axis_names:
            return i
        k = self.mesh.axis_names.index(self.names[0])
        coords = list(self.mesh.coords)
        coords[k] = i
        return int(np.ravel_multi_index(coords, self.mesh.shape))


def _env_ranks():
    """(rank, world, local rank, local world, launched) from the
    variables ``torch.distributed.run`` sets."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return 0, 1, 0, 1, False
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    return (rank, world, int(env.get("LOCAL_RANK", rank)),
            int(env.get("LOCAL_WORLD_SIZE", world)), True)


def check_nccl_devices(local_rank: int, local_world: int,
                       device: torch.device, n_cards: int) -> None:
    """Refuse an ``nccl`` mesh whose ranks would not each hold a card of
    their own: a rank must take ``cuda:LOCAL_RANK`` and the host must have
    a card for every local rank.  Ranks that share a card take ``gloo``."""
    if device.type != "cuda":
        raise ValueError(f"nccl needs a CUDA device, got {device}")
    index = 0 if device.index is None else device.index
    if local_world > n_cards or index != local_rank:
        raise ValueError(
            f"nccl needs a card for each rank: local rank {local_rank} of "
            f"{local_world} on {device} with {n_cards} card(s); ranks that "
            "share a card must pass backend='gloo'")


def _device_and_backend(device, backend, local_rank, local_world):
    device = torch.device(device if device is not None
                          else f"cuda:{local_rank}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {device}: no CUDA card (pass "
                           "device='cpu' for the CPU)")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl":
        check_nccl_devices(local_rank, local_world, device,
                           torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device, backend


def _join(backend: str, rank: int, world: int) -> None:
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()},"
                               f" not {backend}")
        return
    dist.init_process_group(backend, rank=rank, world_size=world)


def make_mesh(n: Optional[int] = None, axis: str = "tiles",
              backend: Optional[str] = None, device=None) -> Mesh:
    """A 1-D mesh over every rank of the launch (``n``, when given, must
    equal the world size).  ``device`` defaults to ``cuda:LOCAL_RANK``;
    ``backend`` None means ``nccl`` on CUDA and ``gloo`` on the CPU."""
    rank, world, local_rank, local_world, launched = _env_ranks()
    if n is not None and n != world:
        raise ValueError(f"requested {n} ranks, the launch has {world}")
    device, backend = _device_and_backend(device, backend, local_rank,
                                          local_world)
    if not launched:
        return Mesh((axis,), (1,), (0,), device, None, (None,))
    _join(backend, rank, world)
    return Mesh((axis,), (world,), (rank,), device, backend,
                (dist.group.WORLD,))


def close(mesh: Mesh) -> None:
    """Leave the mesh's process group once every rank is done with it (a
    rank that exits with the group still up can abort in its teardown).
    A one-rank mesh without a group has nothing to close."""
    if mesh.backend and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


# -- collectives ---------------------------------------------------------------

def axis_index(axis: MeshAxis) -> int:
    return axis.index


def _host(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``x`` where the backend can reach it: on the host under gloo."""
    return x.cpu() if axis.mesh.backend == "gloo" and x.is_cuda else x


def _bytes(x: torch.Tensor, axis: MeshAxis):
    """The bytes a moving collective carries (any dtype), and the function
    that turns such bytes back into a tensor of ``x``'s shape, dtype and
    device."""
    shape, dtype, dev = x.shape, x.dtype, x.device
    y = _host(x.contiguous().reshape(-1).view(torch.uint8), axis)

    def back(z):
        return z.to(dev).view(dtype).reshape(shape)
    return y, back


def psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Sum over the axis (``jax.lax.psum``); bool is refused, as psum has
    no predicate reduction."""
    x = torch.as_tensor(x)
    if x.dtype == torch.bool:
        raise TypeError("psum of bool: convert to an integer type first")
    if axis.group is None:
        return x
    y = _host(x, axis).clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=axis.group)
    return y.to(x.device)


def all_gather(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in axis order
    (``jax.lax.all_gather(..., tiled=True)``); every rank's ``x`` has the
    same shape."""
    if axis.group is None:
        return x
    y, back = _bytes(x, axis)
    parts = [torch.empty_like(y) for _ in range(axis.size)]
    dist.all_gather(parts, y, group=axis.group)
    return torch.cat([back(p) for p in parts])


def gather_padded(ids: torch.Tensor, rows: Sequence[torch.Tensor], per: int,
                  axis: MeshAxis):
    """Merge a list split over the axis: each rank holds at most ``per``
    entries (``ids`` (k,) int64 and rows (k, ...)); pads every part to
    ``per`` with id -1, gathers them and keeps the real entries, in axis
    order.  Returns (ids, rows)."""
    k = ids.shape[0]
    pid = torch.full((per,), -1, dtype=torch.int64, device=ids.device)
    pid[:k] = ids
    padded = []
    for r in rows:
        p = torch.zeros((per,) + tuple(r.shape[1:]), dtype=r.dtype,
                        device=r.device)
        p[:k] = r
        padded.append(p)
    gid = all_gather(pid, axis)
    keep = gid >= 0
    return gid[keep], [all_gather(p, axis)[keep] for p in padded]


def ppermute(x: torch.Tensor, perm, axis: MeshAxis) -> torch.Tensor:
    """``jax.lax.ppermute``: ``perm`` lists (source, destination) axis
    indices; a rank that receives nothing gets zeros.  One send and one
    receive per rank at most, posted together (``batch_isend_irecv``); a
    pair from a rank to itself is a local copy."""
    me = axis.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: rank {me} sends or receives twice")
    if src and src[0] == me:
        return x.clone()
    out = torch.zeros_like(x)
    if not dst and not src:
        return out
    if axis.group is None:
        raise ValueError("ppermute across ranks on a one-rank mesh")
    y, back = _bytes(x, axis)
    buf = torch.empty_like(y)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, y, axis.global_rank(dst[0]),
                              group=axis.group))
    if src:
        ops.append(dist.P2POp(dist.irecv, buf, axis.global_rank(src[0]),
                              group=axis.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return back(buf) if src else out


def broadcast(x: torch.Tensor, axis: MeshAxis, src: int = 0) -> torch.Tensor:
    """``x`` of axis position ``src`` on every rank (same shape and dtype
    everywhere)."""
    if axis.group is None:
        return x
    y, back = _bytes(x, axis)
    y = y.clone()
    dist.broadcast(y, axis.global_rank(src), group=axis.group)
    return back(y)


# -- placement -----------------------------------------------------------------

def shard_rows(x: torch.Tensor, mesh: Mesh, axis=None) -> torch.Tensor:
    """This rank's rows of ``x`` (the JAX package's ``row_sharded``): the
    ``index``-th of ``size`` equal row bands."""
    ax = mesh.axis(axis)
    if x.shape[0] % ax.size:
        raise ValueError(f"{x.shape[0]} rows do not split over {ax.size}")
    n = x.shape[0] // ax.size
    return x[ax.index * n:(ax.index + 1) * n]


def gather_rows(x: torch.Tensor, mesh: Mesh, axis=None) -> torch.Tensor:
    """The whole frame from every rank's band (the inverse of
    :func:`shard_rows`)."""
    return all_gather(x, mesh.axis(axis))


@dataclasses.dataclass(frozen=True)
class _Leaf:
    shape: tuple
    dtype: torch.dtype


def _skeleton(tree):
    """``tree`` with every tensor replaced by its shape and dtype, and the
    tensors in walk order."""
    tensors = []

    def walk(v):
        if torch.is_tensor(v):
            tensors.append(v)
            return _Leaf(tuple(v.shape), v.dtype)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return dataclasses.replace(v, **{
                f.name: walk(getattr(v, f.name))
                for f in dataclasses.fields(v) if f.init})
        if isinstance(v, (list, tuple)):
            return type(v)(walk(e) for e in v)
        if isinstance(v, dict):
            return {k: walk(e) for k, e in v.items()}
        return v
    return walk(tree), tensors


def replicate(tree, mesh: Mesh, src: int = 0):
    """``tree`` (a dataclass, list, tuple or dict of tensors, nested) of
    rank ``src`` on every rank, on the mesh's device: the replicated
    inputs of the sharded frames.  Other ranks may pass None."""
    if mesh.backend is None or mesh.size == 1:
        return tree
    rank = mesh.rank
    skel, tensors = _skeleton(tree) if rank == src else (None, [])
    box = [skel]
    dist.broadcast_object_list(box, src=src)
    skel = box[0]
    ax = mesh.axis()
    it = iter(tensors)

    def fill(v):
        if isinstance(v, _Leaf):
            x = (next(it).to(mesh.device) if rank == src else
                 torch.empty(v.shape, dtype=v.dtype, device=mesh.device))
            return broadcast(x, ax, src)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return dataclasses.replace(v, **{
                f.name: fill(getattr(v, f.name))
                for f in dataclasses.fields(v) if f.init})
        if isinstance(v, (list, tuple)):
            return type(v)(fill(e) for e in v)
        if isinstance(v, dict):
            return {k: fill(e) for k, e in v.items()}
        return v
    return fill(skel)


def band_generator(seed: int, rank: int, device) -> torch.Generator:
    """The GI sample generator of band ``rank`` (the counterpart of the
    JAX package's ``fold_in(key, dev)``): seeded from (seed, rank)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, rank])
                        .generate_state(1, np.uint64)[0] >> 1))
    return gen


# -- launcher ------------------------------------------------------------------

def launch(nproc: int, argv: Sequence[str], *, env=None, timeout=None,
           capture: bool = False) -> subprocess.CompletedProcess:
    """Start ``nproc`` ranks of ``python <argv>`` on this host through
    ``python -m torch.distributed.run --standalone`` (a rendezvous on a
    free local port), one torch thread each, and wait for them.  Returns
    the completed process; its exit code is non-zero when any rank
    failed.  On ``timeout`` every process of the launch is killed and
    ``subprocess.TimeoutExpired`` raised."""
    env = dict(os.environ if env is None else env)
    env.setdefault("OMP_NUM_THREADS", "1")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={int(nproc)}"] + list(argv)
    pipe = subprocess.PIPE if capture else None
    with subprocess.Popen(cmd, env=env, text=True, stdout=pipe, stderr=pipe,
                          start_new_session=True) as proc:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            # the launcher stops its ranks on SIGTERM; then its session
            proc.terminate()
            try:
                proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
            raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)
