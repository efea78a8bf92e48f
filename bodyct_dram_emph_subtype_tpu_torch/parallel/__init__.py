"""The mesh: the process group, its data / spatial / model groups, the
differentiable sum and the epoch-end gather (:mod:`.mesh`); H slabs with
halo exchanges (:mod:`.spatial`); conv output-channel slices
(:mod:`.tensor`)."""
