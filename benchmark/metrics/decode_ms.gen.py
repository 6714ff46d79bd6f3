"""Device milliseconds of ``MagicDrivePipeline.decode`` per frame over the
window (CUDA events around each call)."""


def read(record):
    ms = record.get("decode_ms")
    return None if not ms else sum(ms) / record["frames"]
