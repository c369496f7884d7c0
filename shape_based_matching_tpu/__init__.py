"""shape_based_matching_tpu — LINE-2D shape-based template matching on JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
ddcr/shape_based_matching (LINE-2D / LINEMOD gradient-orientation template
matching). The compute path is functional JAX over static shapes: gradient
extraction, 8-bin orientation quantization, T×T orientation spreading,
cosine-response LUT maps and batched template scoring all run as fused device
code; thousands of rotated/scaled templates score in one launch instead of an
OpenMP loop over templates (reference: line2Dup.cpp:1169).

Public API mirrors the reference Detector (line2Dup.h:257-333):

    from shape_based_matching_tpu import Detector
    det = Detector(num_features=128, T=(4, 8))
    tid = det.add_template(img, "class", mask)
    det.add_template_rotate("class", zero_id=tid, theta=10.0, center=(cx, cy))
    matches = det.match(test_img, threshold=90.0)
"""

__version__ = "0.1.0"

from .models.detector import Detector, Match, get_instance, reset_instance
from .models.refine import RefinedPose, refine_detections
from .models.icp import (IcpResult, MatchIcpHandle, match_icp,
                         match_icp_async, refine_matches_icp)
from .models.template import Feature, Template
from .models.shape_info import ShapeInfoProducer
from .utils.nms import nms_boxes

__all__ = [
    "Detector",
    "Match",
    "Feature",
    "Template",
    "ShapeInfoProducer",
    "RefinedPose",
    "refine_detections",
    "refine_matches_icp",
    "match_icp",
    "match_icp_async",
    "MatchIcpHandle",
    "IcpResult",
    "get_instance",
    "reset_instance",
    "nms_boxes",
    "__version__",
]
