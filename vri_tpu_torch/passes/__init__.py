from vri_tpu_torch.passes.frame import FrameParams, render_frame_gi  # noqa: F401
