from .registry import ARCHS, SHAPES, Shape, cells, config_for_shape, get, \
    sub_quadratic

__all__ = ["ARCHS", "SHAPES", "Shape", "cells", "config_for_shape", "get",
           "sub_quadratic"]
