"""batch_fill (%): the mean decode batch over ``max_batch``, over the window's
``paged_decode_step`` calls."""


def read(rec):
    spans = rec.data.get("spans")
    if not spans or not spans["decodes"]:
        return None
    sizes = [len(ctx) for _, _, ctx in spans["decodes"]]
    return 100.0 * sum(sizes) / len(sizes) / rec.data["max_batch"]
