"""Traffic ``vis_resolve``: the visibility buffer and its albedo resolve.

Each frame is ``Renderer.render(gi=False, mode=DebugMode.ALBEDO,
to_numpy=False)`` from the stage's authored camera shifted by a
sub-pixel jitter (a viewer's TAA jitter): ``jitters`` offsets drawn
uniformly in [-0.5, 0.5) pixels from the seed, taken in turn.  Set-up
syncs the stage, then renders ``warmup_frames`` frames through
``render()`` with the host copy, which climbs the renderer's overflow
ladder (``to_numpy=False`` never climbs it), and one frame at each
jitter.  A frame returns the raster's overflow count, a device scalar
the frame already made, so the harness adds no work to the frame; a
frame fails when the raster overflowed, the last one also when its
colour is not finite.  The check compares a frame of the window drawn
from the seed (``run.KEEP_AMONG``): instance id and depth, and the
resolve's colour, normal and albedo, with the reference visibility
(``reference/visibility.py``) at the same jitter.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from perfbench import roofline
from perfbench.program import make_renderer, make_stage
from perfbench.reference import compare
from perfbench.reference.visibility import visibility
from perfbench.stage_arrays import stage_arrays
from vri_tpu_torch.config import DebugMode


def jittered(cam, dx_ndc: float, dy_ndc: float):
    """``cam`` with its projection shifted by (dx, dy) in NDC."""
    proj = np.array(cam.proj, np.float32)
    proj[0] += np.float32(dx_ndc) * proj[3]
    proj[1] += np.float32(dy_ndc) * proj[3]
    return dataclasses.replace(cam, proj=proj)


class Cell:
    def __init__(self, cfg, wl, seed, device, spans):
        self.cfg, self.wl, self.seed = cfg, wl, seed
        self.device, self.spans = device, spans
        self.mode = DebugMode.ALBEDO
        self.notes_ = {}

    def setup(self):
        cfg = self.cfg
        self.stage = make_stage(cfg)
        self.r = make_renderer(cfg, self.device)
        with self.spans("sync_s"):
            self.r.load_stage(self.stage)
        self.reseed(self.seed)
        self.notes_["ladder"] = (
            f"settled at caps scale "
            f"{getattr(self.r, '_raster_caps_scale', 'unknown')}")

    @functools.cached_property
    def arrays(self):
        """The stage as the reference reads it, made when the check (or
        the roofline's count) first needs it, outside ``setup_s``."""
        return stage_arrays(self.stage)

    def reseed(self, seed):
        """Draw the seed's jitters; climb the ladder; warm up each."""
        cfg, p = self.cfg, self.wl["params"]
        w, h = cfg["width"], cfg["height"]
        rng = np.random.default_rng(seed)
        px = rng.random((p["jitters"], 2)) - 0.5
        # pixel x right is NDC +x; pixel y down is NDC -y
        self.jitter_ndc = [(2.0 * jx / w, -2.0 * jy / h) for jx, jy in px]
        self.cams = [jittered(self.r.camera, *j) for j in self.jitter_ndc]
        self.i = 0
        for k in range(p["warmup_frames"]):
            self.r.render(camera=self.cams[k % len(self.cams)], gi=False,
                          mode=self.mode, backend=cfg["frame"]["backend"],
                          to_numpy=True)
        for _ in self.cams:
            self.frame()

    def frame(self):
        k = self.i % len(self.cams)
        self.i += 1
        aovs = self.r.render(camera=self.cams[k], gi=False, mode=self.mode,
                             backend=self.cfg["frame"]["backend"],
                             to_numpy=False)
        self.last = (k, aovs)
        return aovs.get("raster_overflow_tiles")

    def colour_finite(self) -> bool:
        """Whether the last frame's colour is finite (after the window)."""
        return bool(torch.isfinite(self.last[1]["color"]).all())

    def keep(self):
        """Hold the frame just rendered for the check."""
        self.kept = self.last

    def least_seconds(self):
        ref = visibility(self.arrays, self.cfg["width"], self.cfg["height"],
                         self.device, self.jitter_ndc[self.kept[0]])
        return {"raster_tiles": roofline.raster_least_s(
            ref["fragments"], self.cfg["width"] * self.cfg["height"])}

    def snapshot(self):
        k, aovs = self.kept
        self.out = {key: aovs[key].cpu() for key in
                    ("color", "depth", "instance_id", "normal", "albedo")}
        self.out_jitter = self.jitter_ndc[k]

    def release(self):
        self.snapshot()
        del self.r, self.last, self.kept, self.cams

    def reference(self, quantize=None):
        return visibility(self.arrays, self.cfg["width"], self.cfg["height"],
                          self.device, self.out_jitter, quantize=quantize)

    def compare(self, got, ref):
        got = {k: v.to(self.device) for k, v in got.items()}
        vis, agree = compare.visibility_off(got["instance_id"],
                                            got["depth"], ref)
        gbuf = compare.attributes_off(
            got, ref, agree, (("color", "albedo"), ("albedo", "albedo"),
                              ("normal", "normal")))
        return {"vis_off": vis, "gbuf_off": gbuf}

    def check(self):
        return self.compare(self.out, self.reference())

    def control(self):
        """(program's numbers, control's numbers): the control is the
        reference computed with every stored tensor in bfloat16."""
        ref = self.reference()
        low = self.reference(quantize=compare.bf16)
        low_out = {"instance_id": low["instance"], "depth": low["depth"],
                   "color": low["albedo"], "albedo": low["albedo"],
                   "normal": low["normal"]}
        return self.compare(self.out, ref), self.compare(low_out, ref)

    def notes(self):
        return self.notes_
