"""Device milliseconds of ``TrainState.apply_gradients`` (the clip and
AdamW over the fp32 masters) per step over the window (CUDA events around
each call)."""


def read(record):
    ms = record.get("optimizer_ms")
    return None if not ms else sum(ms) / len(ms)
