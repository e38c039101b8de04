"""Application suites: the paper's image/ML domains (the LM idioms of
the JAX package wait for the jaxpr front end)."""

from . import image, mlkernels
from .image import APPS as IMAGE_APPS
from .mlkernels import ML_APPS


def image_graphs():
    return {name: image.build_graph(name) for name in IMAGE_APPS}


def ml_graphs():
    return {name: mlkernels.build_graph(name) for name in ML_APPS}
