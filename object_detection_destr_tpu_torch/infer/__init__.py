"""Inference: post-processing, the HTTP detection service, the evaluator and the batch CLI."""

from .predict import destr_predict, ssd_predict

__all__ = ["destr_predict", "ssd_predict"]
