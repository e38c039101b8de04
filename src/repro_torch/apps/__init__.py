"""Application suites: the paper's image/ML domains + LM idioms
(``apps.lm.lm_idiom_graphs``, traced from torch functions)."""

from . import image, mlkernels
from .image import APPS as IMAGE_APPS
from .mlkernels import ML_APPS


def image_graphs():
    return {name: image.build_graph(name) for name in IMAGE_APPS}


def ml_graphs():
    return {name: mlkernels.build_graph(name) for name in ML_APPS}
