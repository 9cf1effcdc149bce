"""Weights for the tests that hold the port to ``repro``: ``repro``'s
initial weights with the leaves it initialises to constants drawn from a
seed, so that a left-out term shows. numpy only: the spawned ranks of
``tests/torch_mesh_world.py`` import it too."""
import numpy as np


def perturbed(tree, rng):
    """``tree`` with every bias drawn from N(0, 0.1) and every norm scale
    from 1 + N(0, 0.1): ``repro`` initialises them to 0 and 1."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = perturbed(val, rng)
        elif key in ("b", "bias"):
            out[key] = (0.1 * rng.normal(size=val.shape)).astype(val.dtype)
        elif key == "scale":
            out[key] = (1 + 0.1 * rng.normal(size=val.shape)).astype(
                val.dtype)
        else:
            out[key] = np.asarray(val)
    return out
