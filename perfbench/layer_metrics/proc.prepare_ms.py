"""Host milliseconds of the loader workers' item work after the reads (crop,
dilation, mask-out, then the view's depth selection, pad, gate, lung
selection and moments, or the host path's preprocess) per finished scan
(``stats["stage_ms"]["io.prepare"]``)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["scans"] or "io.prepare" not in p["stage_ms"]:
        return None
    return p["stage_ms"]["io.prepare"] / p["scans"]
