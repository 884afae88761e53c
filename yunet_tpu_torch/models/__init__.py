"""YuNet and SCRFD as nn.Modules, and their BN-folded forwards."""

from ..config import SCRFDConfig
from .detector import YuNet
from .scrfd import SCRFD


def architecture(model_cfg) -> type:
    """The model class of a plan. Both have the detect path's ``fold``,
    ``forward_folded``, ``decode`` and ``num_anchors``."""
    return SCRFD if isinstance(model_cfg, SCRFDConfig) else YuNet
