"""Model FLOPs of every training step completed in the traced window,
summed over its rows at their true lengths, over the window's seconds
times the card's dense TF32 peak (float32 training), per cent."""
from harness.readers import mfu_train as read  # noqa: F401
