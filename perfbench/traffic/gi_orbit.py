"""Traffic ``gi_orbit``: a viewer flying a free camera around the stage,
through the production GI frame.

The configuration's ``camera`` block is the camera path: an orbit of
``radius`` around ``center`` with the eye at ``eye_height``, frame n of
the run (from 0, warm-up included) at azimuth ``azimuth0 + 2 pi n /
frames_per_turn`` (``FreeCamera.at_time`` of the program, 8 s a turn, at
``frames_per_turn / 8`` frames a second).  Set-up syncs the stage
(``Renderer.load_stage``), builds and bakes the SDF cascades around frame
0's eye (``Renderer.ensure_cascades``), draws ``uniform_sets`` sets of GI
uniforms from the seed on the device and renders ``warmup_frames``
frames from an empty history.  Each frame is
``Renderer.render_temporal(state, camera=cam_n)``: the cascades whose
snapped center the camera moved scroll a cell, the radiance is baked
again, then the temporal frame renders from that camera.
A frame returns ``frame_faults``, a device scalar the frame already made,
so the harness adds no work to the frame; a frame fails when it is
non-zero, the last one also when its colour is not finite.

The last ``recorded_frames`` warm-up frames run under
``profiler.start_recording()``: a frame's mean (most frames scroll no
cascade 0) of the device ms (host ms without a card) of the
``sdf_scroll`` span and of the ``sdf.bake`` span (in this cell only a
scroll makes the renderer bake again), and of the cells that entered and
the bricks the scroll emitted (``profiler.count``) go into the harness's
span dict under the per-layer metrics' names.

The check is ``gi_static``'s, each checked frame seen from its own
camera, which the reference works out from the orbit's numbers
(``reference/orbit.py``), never from the program's camera; the
reference builds its cascades from scratch around that eye.  The kept
frame's cascades are compared whole (``sdf_*_off``) and over the voxels
whose cells lay outside the windows the cascades had ``enter_lag`` frames
before (``sdf_enter_*_off``): the region the scrolls between re-binned
and re-emitted, where a stale scroll or a skipped bake shows undiluted by
the rest of the kitchen.

The roofline yardsticks (``least_seconds``) are ``gi_static``'s for R and
M, from the kept frame's camera, and the emit's
(``perfbench/roofline_emit.py``) for the occupied voxels of the
reference's cascades at the kept frame that entered them over the
``enter_lag`` frames before, a frame's mean.
"""

from __future__ import annotations

import math

import torch

from perfbench import roofline, roofline_emit
from perfbench.program import make_renderer, make_stage
from perfbench.reference import compare, lightloop, orbit
from perfbench.reference import sdf as ref_sdf
from perfbench.reference.visibility import visibility
from perfbench.traffic import gi_static
from vri_tpu_torch.hydra.camera import FreeCamera
from vri_tpu_torch.passes import frame as frame_mod
from vri_tpu_torch.runtime import profiler

#: the program's orbit takes this many seconds a turn
ORBIT_SECONDS = 8.0


class Cell(gi_static.Cell):
    def setup(self):
        cfg = self.cfg
        cam = cfg["camera"]
        self.orbit = FreeCamera(
            center=cam["center"], radius=cam["radius"],
            height=cam["eye_height"] - cam["center"][1],
            fov_y_deg=cam["fov_deg"], near=cam["near"], far=cam["far"])
        self.n = 0
        self.stage = make_stage(cfg)
        self.r = make_renderer(cfg, self.device)
        with self.spans("sync_s"):
            self.r.load_stage(self.stage)
        with self.spans("sdf_build_s"):
            self.r.ensure_cascades(eye=self.camera(0).eye)
        self.reseed(self.seed)

    def camera(self, n):
        """The program's camera of frame ``n``: ``FreeCamera.at_time`` at
        the time the orbit reaches that frame's azimuth."""
        cam = self.cfg["camera"]
        t = ORBIT_SECONDS * (cam["azimuth0"] / (2.0 * math.pi)
                             + n / cam["frames_per_turn"])
        return self.orbit.at_time(t, self.cfg["width"] / self.cfg["height"],
                                  orbit_period=ORBIT_SECONDS)

    def reseed(self, seed):
        """Draw the seed's uniforms and warm up from an empty history,
        the last frames recorded for the per-layer metrics."""
        cfg, p, fr = self.cfg, self.wl["params"], self.fr
        h, w = cfg["height"], cfg["width"]
        n_gi = (h // fr["gi_scale"]) * (w // fr["gi_scale"])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.uniforms = torch.rand(
            (p["uniform_sets"], fr["samples"], n_gi, 2), generator=gen,
            device=self.device)
        self.state = frame_mod.init_temporal(h, w, fr["gi_scale"],
                                             device=self.device)
        self.i = 0
        self.frame()
        # the first frame, from an empty history, is kept for the check
        self.keep()
        self.first = self._kept()
        n = p["warmup_frames"] - 1
        for j in range(n):
            if j == max(n - p["recorded_frames"], 0):
                profiler.start_recording()
            self.frame()
        if n:
            self.layer_numbers(profiler.stop_recording())

    def layer_numbers(self, recs):
        """The per-layer metrics, a frame's mean over the recording."""
        frames = sorted({r.frame for r in recs if r.frame >= 0})

        def span_ms(name):
            ms = 0.0
            for r in recs:
                if r.name != name:
                    continue
                if r.device_start_s is not None:
                    ms += 1e3 * (r.device_end_s - r.device_start_s)
                else:
                    ms += 1e-6 * (r.host_end_ns - r.host_start_ns)
            return ms

        counts = profiler.recorded_counts()

        def counted(name):
            return sum(c.value for c in counts if c.name == name)

        per_frame = {
            "scroll_ms": span_ms("sdf_scroll"),
            "scroll_bake_ms": span_ms("sdf.bake"),
            "scroll_cells": counted("sdf_scroll.cells"),
            "scroll_bricks": counted("sdf_scroll.bricks"),
        }
        for name, total in per_frame.items():
            self.spans.seconds[name] = total / len(frames)
        self.notes_["recorded"] = (
            f"{len(frames)} warm-up frames: rebuilds "
            f"{counted('sdf_scroll.rebuilds')}, "
            + ", ".join(f"{k} {v}" for k, v in per_frame.items()))

    def frame(self):
        k = self.i % self.uniforms.shape[0]
        self.i += 1
        fr = self.fr
        self.prev = self.state
        self.frame_n = self.n
        self.n += 1
        self.aovs, self.state = self.r.render_temporal(
            self.state, camera=self.camera(self.frame_n),
            uniforms=self.uniforms[k], samples=fr["samples"],
            gi_scale=fr["gi_scale"], history_cap=fr["history_cap"],
            backend=fr["backend"])
        self.k = k
        return self.aovs["frame_faults"]

    def keep(self):
        """Hold the frame just rendered, and the cascades it read, for
        the check (by reference: a later frame's scroll makes new
        tensors)."""
        self.kept = (self.aovs, self.state, self.prev, self.k)
        self.kept_n, self.kept_cascades = self.frame_n, self.r.cascades

    def _kept(self):
        out = super()._kept()
        out["n"] = self.kept_n
        return out

    def snapshot(self):
        self.window = self._kept()
        cas = self.kept_cascades
        sdf = self.cfg["sdf"]
        self.got_sdf = {
            "occ": (cas.brick_map >= 0).cpu(),
            "surf": ref_sdf.unpack_surface(
                cas.march_fine0, cas.march_fine1, sdf["num_cascades"],
                sdf["cascade_resolution"]).cpu(),
            "voxel_shade": cas.voxel_shade.cpu()}

    def least_seconds(self):
        """R's and M's least times a frame from the kept frame's camera,
        as ``gi_static`` counts them, and the emit's: the occupied voxels
        of the reference's cascades at the kept frame that entered them
        over the ``enter_lag`` frames before, a frame's mean."""
        fr, cfg, sdf = self.fr, self.cfg, self.cfg["sdf"]
        arrays = self.seen_from(self.kept_n)
        rays = roofline.march_rays_per_frame(
            cfg["width"], cfg["height"], len(arrays["light_intensity"]),
            sdf["shadow_scale"], fr["gi_scale"], fr["samples"])
        ref = visibility(arrays, cfg["width"], cfg["height"], self.device)
        out = {"march_rays": roofline.march_least_s(rays),
               "raster_tiles": roofline.raster_least_s(
                   ref["fragments"], cfg["width"] * cfg["height"])}
        lag = self.wl["params"]["enter_lag"]
        cas = ref_sdf.build(arrays, sdf, ref["eye"], self.device)
        before = orbit.camera(cfg["camera"], self.kept_n - lag)
        enter = orbit.entered_voxels(cas, arrays, sdf, before["eye"])
        bricks = int((cas["occ"].cpu() & enter).sum()) / lag
        self.notes_["emit_bricks"] = (
            f"{bricks} bricks entered a frame over the {lag} frames to "
            f"frame {self.kept_n} (reference)")
        out["sdf_emit"] = roofline_emit.emit_least_s(bricks, sdf)
        return out

    def release(self):
        self.snapshot()
        del (self.r, self.aovs, self.state, self.prev, self.uniforms,
             self.kept, self.kept_cascades)

    def seen_from(self, n):
        """The stage as the reference reads it, from frame ``n``'s camera
        as the reference works it out."""
        return {**self.arrays, **orbit.camera(self.cfg["camera"], n)}

    def reference(self, quantize=None):
        """The reference's outputs for the first and the kept frame, each
        from its own camera, on cascades built around its own eye, and
        from the program's history of the frame before; the visibility
        and the cascades compared are the kept frame's, and the voxels
        that entered the cascades over the ``enter_lag`` frames before
        it."""
        cfg, dev = self.cfg, self.device
        out = {}
        for tag, got in (("first", self.first), ("window", self.window)):
            arrays = self.seen_from(got["n"])
            vis = visibility(arrays, cfg["width"], cfg["height"], dev,
                             quantize=quantize)
            cas = ref_sdf.build(arrays, cfg["sdf"], vis["eye"], dev,
                                quantize=quantize)
            prev = tuple(x.to(dev) for x in got["prev"])
            out[tag] = lightloop.temporal_frame(
                vis, cas, arrays, cfg, got["uniforms"].to(dev), prev,
                quantize=quantize)
            out[tag]["valid"] = vis["valid"]
        n = self.window["n"]
        before = orbit.camera(cfg["camera"], n - self.wl["params"]["enter_lag"])
        out["vis"], out["sdf"] = vis, cas
        out["enter"] = orbit.entered_voxels(cas, arrays, cfg["sdf"],
                                            before["eye"])
        return out

    def compare(self, got, ref):
        """``gi_static``'s numbers, each frame's colour over the pixels
        its own camera's reference covers, and the cascades' three
        numbers again over the voxels that entered them."""
        dev = self.device
        win = {k: v.to(dev) for k, v in got["window"].items()
               if torch.is_tensor(v)}
        out = {}
        out["vis_off"], agree = compare.visibility_off(
            win["instance_id"], win["depth"], ref["vis"])
        out["gbuf_off"] = compare.attributes_off(
            win, ref["vis"], agree, (("albedo", "albedo"),
                                     ("normal", "normal")))
        cas = {k: v.to(dev) for k, v in got["sdf"].items()}
        out.update(ref_sdf.compare_cascades(cas, ref["sdf"]))
        enter = ref["enter"].to(dev)

        def owned(c):
            return {"occ": c["occ"] & enter, "surf": c["surf"] & enter,
                    "voxel_shade": c["voxel_shade"]}

        out.update({k.replace("sdf_", "sdf_enter_"): v for k, v in
                    ref_sdf.compare_cascades(owned(cas),
                                             owned(ref["sdf"])).items()})
        for tag, suffix in (("first", "_first"), ("window", "")):
            g = {k: v.to(dev) for k, v in got[tag].items()
                 if torch.is_tensor(v)}
            out[f"color{suffix}"] = compare.relative_l1(
                g["color"], ref[tag]["color"], ref[tag]["valid"])
            out[f"history{suffix}"] = compare.relative_l1(
                g["state"], ref[tag]["state"])
        return out
