"""Device milliseconds of the eval forward's trunk (the stem through
layer4) per batch of either path (``stats["stage_ms"]["trunk"]``, CUDA
events from the forward's start to the model's ``decoder`` mark)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["batches"] or "trunk" not in p["stage_ms"]:
        return None
    return p["stage_ms"]["trunk"] / p["batches"]
