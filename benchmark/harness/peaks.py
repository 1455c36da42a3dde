"""Published peaks of the cards a run may find (NVIDIA's data sheets; dense
rates, no sparsity; at the full power limit)."""

from typing import Optional

PEAKS = {
    # H100 SXM5: TF32 tensor cores 495 TFLOP/s, bf16 989, float32 outside
    # the tensor cores 67, HBM3 3.35 TB/s
    "H100": {"tf32": 495e12, "bf16": 989e12, "f32_simt": 67e12,
             "bytes": 3.35e12},
}


def of(device_name: str) -> Optional[dict]:
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


def flops_peak(peaks: dict, dtype: str) -> float:
    """The peak a share of a ``dtype`` computation is taken against: the
    dense TF32 tensor-core rate for float32, which no float32-accurate
    implementation (3xTF32 included) can pass."""
    return peaks["bf16"] if dtype == "bfloat16" else peaks["tf32"]
