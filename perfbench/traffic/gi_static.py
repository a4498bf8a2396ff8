"""Traffic ``gi_static``: production temporal GI frames from a fixed camera.

Set-up syncs the stage (``Renderer.load_stage``), builds and bakes the
SDF cascades (``Renderer.ensure_cascades``), draws ``uniform_sets`` sets
of GI sample uniforms from the seed on the device (taken in turn, one set
a frame) and renders ``warmup_frames`` frames from an empty history
(``init_temporal``), so the history is full when the window opens.  Each
frame is ``passes.frame.render_frame_gi_temporal`` on the renderer's
scene and cascades from the stage's authored camera.  A frame returns
the raster's overflow count, a device scalar the frame already made, so
the harness adds no work to the frame; a frame fails when the raster
overflowed, the last one also when its colour is not finite.

The check, after the window, on a frame of the window drawn from the seed
(``run.KEEP_AMONG``): visibility (instance id,
depth) and the G-buffer (normal, albedo) against the reference's ray
casting; the SDF occupancy, surface voxels and shading rows the set-up
built against the reference's own build from the same triangles; and
the colour and the new history against the reference lightloop, which
marches its own cascades from its own G-buffer with the frame's
uniforms and blends with the program's history of the frame before
(the history is a running mean over every earlier frame, so the
reference follows the program from there; the first frame, from an
empty history, is checked whole at set-up).
"""

from __future__ import annotations

import functools

import torch

from perfbench import roofline
from perfbench.program import make_renderer, make_stage
from perfbench.reference import compare, lightloop, sdf as ref_sdf
from perfbench.reference.visibility import visibility
from perfbench.stage_arrays import stage_arrays
from vri_tpu_torch.passes import frame as frame_mod


class Cell:
    def __init__(self, cfg, wl, seed, device, spans):
        self.cfg, self.wl, self.seed = cfg, wl, seed
        self.device, self.spans = device, spans
        self.fr = cfg["frame"]
        self.notes_ = {}

    def setup(self):
        cfg = self.cfg
        self.stage = make_stage(cfg)
        self.r = make_renderer(cfg, self.device)
        with self.spans("sync_s"):
            self.r.load_stage(self.stage)
        with self.spans("sdf_build_s"):
            self.r.ensure_cascades()
        self.fp = frame_mod.FrameParams.from_camera(
            self.r.camera, cfg["height"], device=self.device)
        self.reseed(self.seed)

    @functools.cached_property
    def arrays(self):
        """The stage as the reference reads it, made when the check (or
        the roofline's count) first needs it, outside ``setup_s``."""
        return stage_arrays(self.stage)

    def reseed(self, seed):
        """Draw the seed's uniforms and warm up from an empty history."""
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
        for _ in range(p["warmup_frames"] - 1):
            self.frame()

    def frame(self):
        k = self.i % self.uniforms.shape[0]
        self.i += 1
        fr, cfg = self.fr, self.cfg
        self.prev = self.state
        self.aovs, self.state = frame_mod.render_frame_gi_temporal(
            self.r.scene, self.fp, self.r.cascades, self.state,
            height=cfg["height"], width=cfg["width"],
            config=self.r.config.sdf, backend=fr["backend"],
            samples=fr["samples"], use_cache=fr["use_cache"],
            gi_scale=fr["gi_scale"], history_cap=fr["history_cap"],
            lod_tau=self.r.config.lod_tau, uniforms=self.uniforms[k])
        self.k = k
        return self.aovs.get("raster_overflow_tiles")

    def colour_finite(self) -> bool:
        """Whether the last frame's colour is finite (after the window)."""
        return bool(torch.isfinite(self.aovs["color"]).all())

    def keep(self):
        """Hold the frame just rendered for the check."""
        self.kept = (self.aovs, self.state, self.prev, self.k)

    def _kept(self):
        """The kept frame's outputs, its uniforms and the history it
        started from, on the host."""
        aovs, state, prev, k = self.kept
        out = {key: aovs[key].cpu() for key in
               ("color", "depth", "instance_id", "normal", "albedo")}
        out["color"] = out["color"].reshape(-1, 3)
        out["state"] = state.data.cpu()
        out["prev"] = (prev.data.cpu(), prev.view_proj.cpu(),
                       prev.eye.cpu())
        out["uniforms"] = self.uniforms[k].cpu()
        return out

    def least_seconds(self):
        fr, cfg = self.fr, self.cfg
        rays = roofline.march_rays_per_frame(
            cfg["width"], cfg["height"],
            len(self.arrays["light_intensity"]),
            cfg["sdf"]["shadow_scale"], fr["gi_scale"], fr["samples"])
        ref = visibility(self.arrays, cfg["width"], cfg["height"],
                         self.device)
        return {"march_rays": roofline.march_least_s(rays),
                "raster_tiles": roofline.raster_least_s(
                    ref["fragments"], cfg["width"] * cfg["height"])}

    def snapshot(self):
        """What the check compares, on the host: the first frame, the
        kept frame, and the cascades as the frame reads them."""
        self.window = self._kept()
        cas = self.r.cascades
        sdf = self.cfg["sdf"]
        self.got_sdf = {
            "occ": (cas.brick_map >= 0).cpu(),
            "surf": ref_sdf.unpack_surface(
                cas.march_fine0, cas.march_fine1, sdf["num_cascades"],
                sdf["cascade_resolution"]).cpu(),
            "voxel_shade": cas.voxel_shade.cpu()}

    def release(self):
        self.snapshot()
        del (self.r, self.fp, self.aovs, self.state, self.prev,
             self.uniforms, self.kept)

    def reference(self, quantize=None):
        """The reference's outputs for the first and the kept frame, each
        from the program's history of the frame before."""
        cfg, dev = self.cfg, self.device
        vis = visibility(self.arrays, cfg["width"], cfg["height"], dev,
                         quantize=quantize)
        cas = ref_sdf.build(self.arrays, cfg["sdf"], vis["eye"], dev,
                            quantize=quantize)
        out = {"vis": vis, "sdf": cas}
        for tag, got in (("first", self.first), ("window", self.window)):
            prev = tuple(x.to(dev) for x in got["prev"])
            out[tag] = lightloop.temporal_frame(
                vis, cas, self.arrays, cfg, got["uniforms"].to(dev), prev,
                quantize=quantize)
        return out

    def compare(self, got, ref):
        """The numbers compared: ``got`` holds the program's outputs (or
        the control's), ``ref`` the reference's."""
        dev = self.device
        win = {k: v.to(dev) for k, v in got["window"].items()
                if torch.is_tensor(v)}
        out = {}
        out["vis_off"], agree = compare.visibility_off(
            win["instance_id"], win["depth"], ref["vis"])
        out["gbuf_off"] = compare.attributes_off(
            win, ref["vis"], agree, (("albedo", "albedo"),
                                      ("normal", "normal")))
        out.update(ref_sdf.compare_cascades(
            {k: v.to(dev) for k, v in got["sdf"].items()}, ref["sdf"]))
        valid = ref["vis"]["valid"]
        for tag, suffix in (("first", "_first"), ("window", "")):
            g = {k: v.to(dev) for k, v in got[tag].items()
                 if torch.is_tensor(v)}
            out[f"color{suffix}"] = compare.relative_l1(
                g["color"], ref[tag]["color"], valid)
            out[f"history{suffix}"] = compare.relative_l1(
                g["state"], ref[tag]["state"])
        return out

    def outputs(self):
        return {"first": self.first, "window": self.window,
                "sdf": self.got_sdf}

    def check(self):
        return self.compare(self.outputs(), self.reference())

    def control(self):
        """(program's numbers, control's numbers): the control is the
        reference computed with every stored tensor in bfloat16."""
        ref = self.reference()
        low = self.reference(quantize=compare.bf16)
        low_out = {
            "first": low["first"],
            "window": {"instance_id": low["vis"]["instance"],
                       "depth": low["vis"]["depth"],
                       "normal": low["vis"]["normal"],
                       "albedo": low["vis"]["albedo"],
                       **low["window"]},
            "sdf": {k: low["sdf"][k] for k in ("occ", "surf",
                                               "voxel_shade")}}
        return (self.compare(self.outputs(), ref),
                self.compare(low_out, ref))

    def notes(self):
        return self.notes_
