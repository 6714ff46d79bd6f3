"""Model FLOPs of the training steps the window completed (counted on the
reference, ``harness/flops.py``) over the window's seconds and the card's
bf16 tensor peak (``readers.mfu``)."""
from benchmark.harness.readers import mfu as read  # noqa: F401
