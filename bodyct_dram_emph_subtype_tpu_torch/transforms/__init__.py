"""Training augmentation of the port (``transforms/batch_augment.py``)."""
