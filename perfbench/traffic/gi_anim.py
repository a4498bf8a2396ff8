"""Traffic ``gi_anim``: playback of an animated stage through the
production GI frame.

The stage carries authored motion (the configuration's generator, e.g.
``kitchen_anim``: one prop on a circle, one turn every ``period`` time
codes).  Set-up syncs the stage at its default time
(``Renderer.load_stage``), builds and bakes the SDF cascades
(``Renderer.ensure_cascades``), draws ``uniform_sets`` sets of GI
uniforms from the seed on the device and renders ``warmup_frames``
frames from an empty history.  Frame n of the run (from 1, warm-up
included) plays time code n mod ``period`` through
``Renderer.render_temporal(state, time_code=...)``: the Hydra sync of
the moved xform, the bounded SDF update, the partial radiance re-bake
and the temporal frame, the history kept on the device.  A frame
returns ``frame_faults``, a device scalar the frame already made (the
raster's overflow plus the update's ``needs_full``), so the harness adds
no work to the frame; a frame fails when it is non-zero, the last one
also when its colour is not finite.

The last four warm-up frames run under ``profiler.start_recording()``;
the median a frame of the ``scene_sync`` span's host ms, the
``sdf_update`` and ``rebake`` spans' device ms (host ms without a card),
and the bricks re-emitted and re-baked (``profiler.count``) go into the
harness's span dict under the per-layer metrics' names.

The check is ``gi_static``'s, on the stage at each checked frame's time
code (``reference/timesamples.py``): visibility, G-buffer, colour and
history against the reference, and the cascades the kept frame read
(held by reference, no copy in the window) against the reference's
from-scratch build of the scene at that frame's time code: over all
cascades (``sdf_*_off``), and over the region the frame's update owns
(``sdf_near_*_off``: the voxels within reach of the moved prop's bounds
at the frame's code and the code before, ``roofline_emit.near_voxels``),
where a stale update or a skipped re-bake shows undiluted by the rest of
the kitchen.
"""

from __future__ import annotations

import statistics

import torch

from perfbench import roofline_emit
from perfbench.program import make_renderer, make_stage
from perfbench.reference import compare, lightloop, sdf as ref_sdf
from perfbench.reference.timesamples import at_time
from perfbench.reference.visibility import visibility
from perfbench.stage_arrays import stage_arrays
from perfbench.traffic import gi_static
from vri_tpu_torch.passes import frame as frame_mod
from vri_tpu_torch.runtime import profiler

#: warm-up frames whose spans and counts the per-layer metrics read
RECORDED_FRAMES = 4


class Cell(gi_static.Cell):
    def setup(self):
        cfg = self.cfg
        self.period = int(cfg["stage"]["args"].get("period", 9))
        self.n = 0
        self.stage = make_stage(cfg)
        self.r = make_renderer(cfg, self.device)
        with self.spans("sync_s"):
            self.r.load_stage(self.stage)
        with self.spans("sdf_build_s"):
            self.r.ensure_cascades()
        self.reseed(self.seed)

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
            if j == max(n - RECORDED_FRAMES, 0):
                profiler.start_recording()
            self.frame()
        if n:
            self.layer_numbers(profiler.stop_recording())

    def layer_numbers(self, recs):
        """The per-layer metrics, a frame's median over the recording."""
        frames = sorted({r.frame for r in recs if r.frame >= 0})

        def span_ms(name, device):
            out = []
            for f in frames:
                ms = 0.0
                for r in recs:
                    if r.frame != f or r.name != name:
                        continue
                    if device and r.device_start_s is not None:
                        ms += 1e3 * (r.device_end_s - r.device_start_s)
                    else:
                        ms += 1e-6 * (r.host_end_ns - r.host_start_ns)
                out.append(ms)
            return out

        counts = profiler.recorded_counts()

        def counted(name):
            return [sum(c.value for c in counts
                        if c.frame == f and c.name == name) for f in frames]

        per_frame = {
            "scene_sync_ms": span_ms("scene_sync", False),
            "sdf_update_ms": span_ms("sdf_update", True),
            "rebake_ms": span_ms("rebake", True),
            "update_bricks": counted("sdf_update.bricks"),
            "rebake_bricks": counted("rebake.bricks"),
        }
        for name, values in per_frame.items():
            if values:
                self.spans.seconds[name] = statistics.median(values)
        cells = counted("sdf_update.cells")
        full = counted("sdf_update.needs_full")
        self.notes_["recorded"] = (
            f"{len(frames)} warm-up frames: dirty cells {cells}, "
            f"needs_full {full}, "
            + ", ".join(f"{k} {v}" for k, v in per_frame.items()))

    def frame(self):
        k = self.i % self.uniforms.shape[0]
        self.i += 1
        self.n += 1
        fr = self.fr
        self.code = float(self.n % self.period)
        self.prev = self.state
        self.aovs, self.state = self.r.render_temporal(
            self.state, time_code=self.code, uniforms=self.uniforms[k],
            samples=fr["samples"], gi_scale=fr["gi_scale"],
            history_cap=fr["history_cap"], backend=fr["backend"])
        self.k = k
        return self.aovs["frame_faults"]

    def keep(self):
        """Hold the frame just rendered, and the cascades it read, for
        the check (by reference: a later frame's update makes new
        tensors)."""
        self.kept = (self.aovs, self.state, self.prev, self.k)
        self.kept_code, self.kept_cascades = self.code, self.r.cascades

    def _kept(self):
        out = super()._kept()
        out["code"] = self.kept_code
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
        """``gi_static``'s, and the emit's least time a frame
        (``perfbench/roofline_emit.py``) at the last frame's time code,
        from the stage there and at the code before (the codes' counts
        differ by under 3%)."""
        out = super().least_seconds()
        code = self.code
        before = self.arrays_at(float((int(code) - 1) % self.period))
        after = self.arrays_at(code)
        sdf = self.cfg["sdf"]
        cas = ref_sdf.build(after, sdf, after["eye"], self.device)
        bricks = roofline_emit.emit_bricks(
            cas, roofline_emit.moved_boxes(before, after), sdf)
        self.notes_["emit_bricks"] = (
            f"{bricks} bricks to re-emit at code {code} (reference)")
        out["sdf_emit"] = roofline_emit.emit_least_s(bricks, sdf)
        return out

    def release(self):
        self.snapshot()
        del (self.r, self.aovs, self.state, self.prev, self.uniforms,
             self.kept, self.kept_cascades)

    def arrays_at(self, code):
        """The stage as the reference reads it at time code ``code``."""
        return stage_arrays(at_time(self.stage, code))

    def reference(self, quantize=None):
        """The reference's outputs for the first and the kept frame, each
        on the stage at its own time code and from the program's history
        of the frame before; the visibility and the cascades compared are
        the reference's at the kept frame's time code."""
        cfg, dev = self.cfg, self.device
        out, built = {}, {}
        for tag, got in (("first", self.first), ("window", self.window)):
            code = got["code"]
            if code not in built:
                built.clear()
                arrays = self.arrays_at(code)
                vis = visibility(arrays, cfg["width"], cfg["height"], dev,
                                 quantize=quantize)
                cas = ref_sdf.build(arrays, cfg["sdf"], vis["eye"], dev,
                                    quantize=quantize)
                built[code] = (arrays, vis, cas)
            arrays, vis, cas = built[code]
            prev = tuple(x.to(dev) for x in got["prev"])
            out[tag] = lightloop.temporal_frame(
                vis, cas, arrays, cfg, got["uniforms"].to(dev), prev,
                quantize=quantize)
            out[tag]["valid"] = vis["valid"]
        # the region the kept frame's update owns: its code and the one
        # before
        before = self.arrays_at(float((int(code) - 1) % self.period))
        out["vis"], out["sdf"] = vis, cas
        out["near"] = roofline_emit.near_voxels(
            cas, roofline_emit.moved_boxes(before, arrays), cfg["sdf"])
        return out

    def compare(self, got, ref):
        """``gi_static``'s numbers, each frame's colour over the pixels
        its own time code's reference covers, and the cascades' three
        numbers again over the voxels near the moved prop."""
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
        near = ref["near"].to(dev)

        def owned(c):
            return {"occ": c["occ"] & near, "surf": c["surf"] & near,
                    "voxel_shade": c["voxel_shade"]}

        out.update({k.replace("sdf_", "sdf_near_"): v for k, v in
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
