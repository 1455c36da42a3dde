"""Model FLOPs of every request answered in the traced window, at its true
ids and frames, over the window's seconds times the card's dense TF32
peak (float32 voices), per cent."""
from harness.readers import mfu_serve as read  # noqa: F401
