"""Datasets and the batch loader."""
from .dataset import BaseDataset, FolderDataset, Loader, NormalizedDataset

__all__ = ["BaseDataset", "FolderDataset", "Loader", "NormalizedDataset"]
