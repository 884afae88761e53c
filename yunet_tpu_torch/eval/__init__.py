"""Inference and evaluation: the Detector, the WIDER protocol and VOC mAP."""

from .detect import Detector, resize_img
from .widerface import wider_evaluation, eval_map
from .eval_hook import widerface_eval_mode

__all__ = ["Detector", "resize_img", "wider_evaluation", "eval_map",
           "widerface_eval_mode"]
