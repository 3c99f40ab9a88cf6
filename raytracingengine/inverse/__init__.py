from raytracingengine.inverse.loss import l1_image_loss, l2_image_loss
from raytracingengine.inverse.optimize import fit, make_train_step, masked_optimizer
from raytracingengine.inverse.params import combine, partition

__all__ = [
    "l1_image_loss",
    "l2_image_loss",
    "fit",
    "make_train_step",
    "masked_optimizer",
    "combine",
    "partition",
]
