"""Helpers for loading the goldens generated from the compiled C++ reference."""

import gzip
import json
import os

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def golden_path(name: str) -> str:
    return os.path.join(GOLDEN_DIR, name)


def load_mat(name: str, dtype=None) -> np.ndarray:
    """Load a dumped cv::Mat: int32 header (rows, cols, channels) + data.

    dtype=None infers from the golden name (the historical kern_sim*
    u16 convention); pass it explicitly for other u16 dumps."""
    path = golden_path(name)
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path += ".gz"
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        rows, cols, ch = np.frombuffer(f.read(12), np.int32)
        if dtype is None:
            dtype = np.uint16 if name.startswith("kern_sim") \
                and "64" not in name and "local64" not in name else np.uint8
        data = np.frombuffer(f.read(), dtype)
    shape = (int(rows), int(cols)) + ((int(ch),) if ch > 1 else ())
    return data.reshape(shape)


def load_json(name: str):
    with open(golden_path(name)) as f:
        return json.load(f)


def case1_detector():
    """The upstream case1 angle-demo bank rebuilt from committed goldens:
    one template trained from the case1 ROI and mask, plus 360 rotations
    at 1° steps about the image centre (the recipe
    test_golden_training.py pins against the compiled reference). It
    reproduces case1_matches.json exactly."""
    from shape_based_matching_tpu import Detector

    det = Detector(num_features=128, T=(4, 8))
    img = load_mat("case1_train_img.bin")
    mask = load_mat("case1_train_mask.bin")
    assert det.add_template(img, "test", mask) == 0
    center = (img.shape[1] / 2.0, img.shape[0] / 2.0)
    det.add_templates_rotate("test", 0, [float(a) for a in range(1, 361)],
                             center)
    return det


def case0_detector():
    """The committed case0 training bank (case0_train_templates.json:
    scales 0.1..1.0 in 0.1 steps, pinned against the compiled reference
    by test_golden_training.py) loaded into a Detector."""
    from shape_based_matching_tpu import Detector
    from shape_based_matching_tpu.models.template import Feature, Template

    doc = load_json("case0_train_templates.json")
    det = Detector(num_features=150, T=(4, 8))
    det.class_templates[doc["class_id"]] = [
        [Template(width=t["width"], height=t["height"], tl_x=t["tl_x"],
                  tl_y=t["tl_y"], pyramid_level=t["pyramid_level"],
                  features=[Feature(int(x), int(y), int(lb))
                            for x, y, lb in t["features"]])
         for t in tp]
        for tp in doc["templates"]]
    return det
