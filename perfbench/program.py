"""What the benchmark takes from the program, ``vri_tpu_torch``: the
renderer built from a configuration file, and the procedural stage the
configuration names (the benchmark's input)."""

from __future__ import annotations

from vri_tpu_torch import RenderConfig, SceneLimits, SDFConfig, scenes
from vri_tpu_torch.renderer import Renderer


def render_config(cfg: dict) -> RenderConfig:
    kw = dict(cfg["render"])
    if "limits" in kw:
        kw["limits"] = SceneLimits(**kw["limits"])
    if "sdf" in cfg:
        kw["sdf"] = SDFConfig(**cfg["sdf"])
    return RenderConfig(width=cfg["width"], height=cfg["height"], **kw)


def make_stage(cfg: dict):
    st = cfg["stage"]
    return getattr(scenes, st["generator"])(**st["args"])


def make_renderer(cfg: dict, device) -> Renderer:
    return Renderer(render_config(cfg), device=device)
