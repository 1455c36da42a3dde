"""The plain reference of a VITS training step: a frozen copy of the
program's plain PyTorch modules (``phoonnx_tpu_torch/models/vits``,
``ops/stft.py``, ``ops/mas.py``'s plain version, ``train/losses.py``,
``train/dataset.py``, the float32 path of ``train/step.py`` and the
weight import of ``models/vits/load.py``), rewired to import only each
other, without the kernels, the CUDA graphs or data parallelism. The
program's plain modules are held against the JAX package by the
repository's tests; this copy stays as it is when the program changes.
"""
