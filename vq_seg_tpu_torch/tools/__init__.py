"""Offline dataset preparation, the port's copy of the JAX package's
``tools/``: SLIC superpixels (``slic``), saliency maps (``saliency``) and
OBIA pseudo-labels (``obia``, with its own random forest in ``forest``).
Host numpy and scipy; nothing here needs skimage, sklearn or OpenCV."""
