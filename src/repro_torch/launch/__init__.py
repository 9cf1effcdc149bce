from .mesh import batch_axes, make_debug_mesh, make_production_mesh
from .steps import (StepBundle, abstract_params, make_decode_step,
                    make_prefill_step, make_train_step)

__all__ = ["batch_axes", "make_debug_mesh", "make_production_mesh",
           "StepBundle", "abstract_params", "make_decode_step",
           "make_prefill_step", "make_train_step"]
