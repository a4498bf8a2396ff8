# Copy of vri_tpu/usd/__init__.py for the port; only the imports differ.
from vri_tpu_torch.usd.usda import Attribute, Prim, parse_usda, write_usda  # noqa: F401
from vri_tpu_torch.usd.stage import Stage  # noqa: F401
