from .criterion import set_criterion
from .matcher import hungarian_cost_matrix, hungarian_match

__all__ = ["hungarian_cost_matrix", "hungarian_match", "set_criterion"]
