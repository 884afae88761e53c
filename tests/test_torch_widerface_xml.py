"""The port's VOC-XML WIDER reader (yunet_tpu_torch/data/widerface_xml.py)
against yunet_tpu's on a VOC-XML set written here: faces among non-face
objects, an image with no face, one with no <folder>, in and out of
test_mode. The records must be equal, field for field and dtype for
dtype."""

import dataclasses

import numpy as np
import pytest

from yunet_tpu.data.widerface_xml import parse_widerface_xml as jax_parse
from yunet_tpu_torch.data.widerface_xml import parse_widerface_xml


def _obj(name, box):
    return ("<object><name>%s</name><bndbox><xmin>%s</xmin><ymin>%s</ymin>"
            "<xmax>%s</xmax><ymax>%s</ymax></bndbox></object>"
            % ((name,) + tuple(box)))


def _xml(objects, folder="0--Parade", size=(1024, 683)):
    head = f"<folder>{folder}</folder>" if folder is not None else ""
    return (f"<annotation>{head}<size><width>{size[0]}</width>"
            f"<height>{size[1]}</height><depth>3</depth></size>"
            + "".join(objects) + "</annotation>")


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """A WIDERFace-VOC root and its index: (index file, root)."""
    root = tmp_path_factory.mktemp("voc")
    (root / "Annotations").mkdir()
    rng = np.random.RandomState(3)

    def boxes(n):
        xy = rng.uniform(0, 900, (n, 2)).round(1)
        return np.concatenate([xy, xy + rng.uniform(4, 120, (n, 2)).round(1)],
                              1)

    files = {
        "a_three_faces": _xml([_obj("face", b) for b in boxes(3)]),
        "b_faces_and_others": _xml(
            [_obj("face", boxes(1)[0]), _obj("cat", boxes(1)[0]),
             _obj("face", boxes(1)[0]), _obj("person", boxes(1)[0])],
            folder="12--Group", size=(800, 1200)),
        "c_no_face": _xml([_obj("cat", boxes(1)[0])]),
        "d_no_folder": _xml([_obj("face", b) for b in boxes(2)],
                            folder=None, size=(640, 480)),
        "e_empty": _xml([], folder="3--Riot"),
    }
    for stem, text in files.items():
        (root / "Annotations" / f"{stem}.xml").write_text(text)
    index = root / "index.txt"
    index.write_text("\n".join(files) + "\n\n")
    return str(index), str(root)


def _as_tuple(rec):
    return [(f.name, getattr(rec, f.name)) for f in dataclasses.fields(rec)]


@pytest.mark.parametrize("test_mode", [False, True])
def test_records_equal_jax(voc, test_mode):
    got = parse_widerface_xml(*voc, test_mode=test_mode)
    want = jax_parse(*voc, test_mode=test_mode)
    assert len(got) == len(want) == (5 if test_mode else 3)
    for g, w in zip(got, want):
        for (name, a), (_, b) in zip(_as_tuple(g), _as_tuple(w)):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, name


def test_folder_faces_and_empty_images(voc):
    recs = {r.filename: r for r in parse_widerface_xml(*voc, test_mode=True)}
    assert "d_no_folder.jpg" in recs            # no <folder>: no prefix
    assert recs["12--Group/b_faces_and_others.jpg"].bboxes.shape == (2, 4)
    assert recs["0--Parade/c_no_face.jpg"].bboxes.shape == (0, 4)
    assert recs["3--Riot/e_empty.jpg"].kps.shape == (0, 5, 3)
    train = [r.filename for r in parse_widerface_xml(*voc)]
    assert train == ["0--Parade/a_three_faces.jpg",
                     "12--Group/b_faces_and_others.jpg", "d_no_folder.jpg"]
