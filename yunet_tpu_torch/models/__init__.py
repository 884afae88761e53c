"""YuNet, SCRFD and RetinaFace as nn.Modules, and their BN-folded
forwards."""

from ..config import RetinaFaceConfig, SCRFDConfig
from .detector import YuNet
from .retinaface import RetinaFace
from .scrfd import SCRFD


def architecture(model_cfg) -> type:
    """The model class of a plan. Each has the detect path's ``fold``,
    ``forward_folded``, ``decode``, ``num_anchors`` and ``priors``, and
    ``count_macs``."""
    if isinstance(model_cfg, SCRFDConfig):
        return SCRFD
    if isinstance(model_cfg, RetinaFaceConfig):
        return RetinaFace
    return YuNet
