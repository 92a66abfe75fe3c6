"""Segmentation metrics on the device."""
from .measurement import (Measurement, accuracy, confusion_matrix, f1score, miou, precision,
                          recall)

__all__ = ["Measurement", "accuracy", "confusion_matrix", "f1score", "miou", "precision",
           "recall"]
