from .criterion import set_criterion, ssd_criterion
from .matcher import decode_ssd_boxes, hungarian_cost_matrix, hungarian_match, ssd_match
from .metrics import CocoAveragePrecision, MeanAveragePrecision

__all__ = ["CocoAveragePrecision", "MeanAveragePrecision", "decode_ssd_boxes", "hungarian_cost_matrix",
           "hungarian_match", "set_criterion", "ssd_criterion", "ssd_match"]
