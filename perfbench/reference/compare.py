"""The numbers that decide ``correct``: each compares what the program
produced with what the plain reference computed from the same inputs.

Instance ids are compared through the one-to-one map that pairs each of
the program's ids with the reference id it shares the most pixels with
(the program numbers instances in its own order); a pixel counts as off
when it is covered on one side only, when its mapped id differs, or when
its depth differs by more than ``DEPTH_REL`` of the reference's.
"""

from __future__ import annotations

import torch

DEPTH_REL = 1e-4      # a depth off by more than this share is off
ATTR_ABS = 1e-3       # a normal or colour component off by more is off


def id_map(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Program instance ids -> reference ids (-2 where a program id has
    no partner), by shared pixels, one to one."""
    both = (prog >= 0) & (ref >= 0)
    p, r = prog[both].long(), ref[both].long()
    n_p = int(prog.max()) + 1 if prog.numel() else 0
    n_r = int(ref.max()) + 1 if ref.numel() else 0
    out = torch.full((max(n_p, 1),), -2, dtype=torch.long,
                     device=prog.device)
    if p.numel() == 0:
        return out
    pairs, cnt = torch.unique(p * n_r + r, return_counts=True)
    pp, rr = pairs // n_r, pairs % n_r
    # strongest pairs first; each side takes its first partner only
    order = torch.argsort(cnt, descending=True, stable=True)
    pp, rr = pp[order].tolist(), rr[order].tolist()
    taken_p, taken_r = set(), set()
    for a, b in zip(pp, rr):
        if a not in taken_p and b not in taken_r:
            taken_p.add(a)
            taken_r.add(b)
            out[a] = b
    return out


def visibility_off(prog_inst, prog_depth, ref: dict):
    """(share of pixels off, mask of pixels whose ids agree)."""
    pi = prog_inst.reshape(-1).long()
    ri = ref["instance"].reshape(-1).long()
    mapped = torch.where(pi >= 0, id_map(pi, ri)[torch.clamp(pi, min=0)],
                         torch.full_like(pi, -1))
    agree = (mapped == ri) & (ri >= 0)
    pd = prog_depth.reshape(-1).double()
    rd = ref["depth"].reshape(-1).double()
    depth_ok = torch.abs(pd - rd) <= DEPTH_REL * rd
    off = ~((agree & depth_ok) | ((pi < 0) & (ri < 0)))
    return float(off.double().mean()), agree & depth_ok


def attributes_off(prog: dict, ref: dict, agree, keys) -> float:
    """Share of the pixels whose ids agree where any component of the
    named attributes (program key, reference key) differs by more than
    ``ATTR_ABS``."""
    bad = torch.zeros_like(agree)
    for pk, rk in keys:
        a = prog[pk].reshape(agree.shape[0], -1).double()
        b = ref[rk].reshape(agree.shape[0], -1).double()
        bad |= (torch.abs(a - b) > ATTR_ABS).any(-1)
    n = int(agree.sum())
    return float((bad & agree).sum()) / max(n, 1)


def relative_l1(a: torch.Tensor, b: torch.Tensor, mask=None) -> float:
    """sum |a - b| / sum |b| over ``mask`` (every element without one)."""
    a, b = a.double(), b.double()
    if mask is not None:
        a, b = a[mask], b[mask]
    return float(torch.abs(a - b).sum() / torch.clamp(torch.abs(b).sum(),
                                                        min=1e-30))


def bf16(t: torch.Tensor) -> torch.Tensor:
    """The control's rounding: a tensor stored in bfloat16, read back in
    its own type."""
    return t.to(torch.bfloat16).to(t.dtype)
