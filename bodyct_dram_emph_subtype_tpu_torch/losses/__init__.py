"""Loss primitives of both training strategies (``losses.py``)."""
from .losses import (BETA, GAMMA, binary_dice, dice_coef,
                     generate_regression_labels, interval_regression_loss,
                     masked_balanced_bce, ratio_to_label_batch,
                     segmentation_losses, weighted_cross_entropy)

__all__ = ["BETA", "GAMMA", "binary_dice", "dice_coef",
           "generate_regression_labels", "interval_regression_loss",
           "masked_balanced_bce", "ratio_to_label_batch",
           "segmentation_losses", "weighted_cross_entropy"]
