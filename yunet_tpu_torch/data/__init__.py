"""Host data: the labelv2 annotation parser and the decoded-image cache."""

from .labelv2 import parse_labelv2, Record

__all__ = ["parse_labelv2", "Record"]
