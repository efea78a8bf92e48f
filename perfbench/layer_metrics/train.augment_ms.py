"""Device milliseconds per measured step of the ``augment`` phase: CUDA
events at the trainer's ``augment`` mark and the next one."""


def read(rec):
    t = rec.get("train")
    if not t or not t["steps"]:
        return None
    return t["phase_ms"]["augment"]
