"""DESTR inference: post-processing and the HTTP detection service."""

from .predict import destr_predict

__all__ = ["destr_predict"]
