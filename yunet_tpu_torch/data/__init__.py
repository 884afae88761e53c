"""Host data: the labelv2 annotation parser, the decoded-image cache, the
train augmentations, the dataset and the TrainLoader (the exports of
``yunet_tpu/data/__init__.py``)."""

from .labelv2 import parse_labelv2, Record
from .transforms import (random_square_crop, resize_with_targets,
                         horizontal_flip, KPS_FLIP_ORDER)
from .dataset import WiderFaceDataset, pack_batch
from .loader import TrainLoader

__all__ = ["parse_labelv2", "Record", "random_square_crop",
           "resize_with_targets", "horizontal_flip", "KPS_FLIP_ORDER",
           "WiderFaceDataset", "pack_batch", "TrainLoader"]
