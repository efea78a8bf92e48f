"""Device milliseconds per measured step of the ``forward`` phase: CUDA
events at the trainer's ``forward`` mark and the next one."""


def read(rec):
    t = rec.get("train")
    if not t or not t["steps"]:
        return None
    return t["phase_ms"]["forward"]
