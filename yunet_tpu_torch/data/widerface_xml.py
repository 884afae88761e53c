"""Alternate WIDER Face reader: VOC-XML annotations — a copy of
``yunet_tpu/data/widerface_xml.py`` (numpy and ElementTree only;
reference mmdet/datasets/wider_face.py:12-54 — not used by the shipped
configs but part of the dataset surface).

Expects the WIDERFace-VOC layout:
  root/Annotations/<name>.xml   (VOC objects with <name>face</name>)
  root/JPEGImages/<folder>/<name>.jpg
and an index file listing image stems, one per line.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from .labelv2 import NK, Record


def parse_widerface_xml(index_file: str, root: str,
                        test_mode: bool = False) -> List[Record]:
    records: List[Record] = []
    with open(index_file) as f:
        stems = [ln.strip() for ln in f if ln.strip()]
    for stem in stems:
        xml_path = os.path.join(root, "Annotations", f"{stem}.xml")
        tree = ET.parse(xml_path)
        xroot = tree.getroot()
        size = xroot.find("size")
        width = int(size.find("width").text)
        height = int(size.find("height").text)
        folder = xroot.find("folder")
        folder = folder.text if folder is not None else ""
        boxes = []
        for obj in xroot.findall("object"):
            if obj.find("name").text != "face":
                continue
            bnd = obj.find("bndbox")
            boxes.append([float(bnd.find(t).text) for t in
                          ("xmin", "ymin", "xmax", "ymax")])
        if not boxes and not test_mode:
            continue
        bboxes = (np.asarray(boxes, np.float32) if boxes
                  else np.zeros((0, 4), np.float32))
        n = bboxes.shape[0]
        records.append(Record(
            filename=os.path.join(folder, f"{stem}.jpg"),
            width=width, height=height, bboxes=bboxes,
            labels=np.zeros((n,), np.int64),
            kps=np.zeros((n, NK, 3), np.float32),
            bboxes_ignore=np.zeros((0, 4), np.float32)))
    return records
