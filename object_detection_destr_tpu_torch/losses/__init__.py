from .criterion import set_criterion
from .matcher import hungarian_cost_matrix, hungarian_match
from .metrics import CocoAveragePrecision, MeanAveragePrecision

__all__ = ["CocoAveragePrecision", "MeanAveragePrecision", "hungarian_cost_matrix", "hungarian_match",
           "set_criterion"]
