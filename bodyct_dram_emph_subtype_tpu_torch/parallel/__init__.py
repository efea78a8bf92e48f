"""Data-parallel training: the process group, the differentiable sum and
the epoch-end gather (:mod:`.mesh`)."""
