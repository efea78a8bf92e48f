"""Device milliseconds per measured step of the ``backward`` phase: CUDA
events at the trainer's ``backward`` mark and the next one."""


def read(rec):
    t = rec.get("train")
    if not t or not t["steps"]:
        return None
    return t["phase_ms"]["backward"]
