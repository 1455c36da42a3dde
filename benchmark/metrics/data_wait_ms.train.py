"""Mean ms the training loop waits on the program's BucketedLoader for its
next batch (prefetch 2, as the trainer runs it)."""
from harness.readers import mean_of


def read(r):
    return mean_of(r, "data_wait_ms")
