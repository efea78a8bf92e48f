"""Host milliseconds per measured step from the batch fetch (the trainer's
``loader`` mark) to the step's next mark: the wait for the loader and
the upload."""


def read(rec):
    t = rec.get("train")
    if not t or not t["steps"]:
        return None
    return t["phase_ms"]["loader"]
