"""Training-side array ops: alignment search (kernel D) and STFT/mel."""
