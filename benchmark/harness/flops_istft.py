"""Operations and bytes of a multi-band iSTFT decoder's head, in closed
form: what follows the last upsampling stage (``reference/mb_istft.py``
``heads``, ``istft``, ``pqmf_synthesis``) for one utterance of ``frames``
latent frames.

``flops.py``'s conventions: multiply-adds x 2 of the dense linear algebra,
elementwise work (the activations, ``exp``, ``sin``, the envelope's
division) left out, a transposed conv counted as T_in x I x O x K. The
overlap-add is counted as the work it needs, each frame's samples
multiplied by the window and added once, whatever form the program gives
it. The least bytes are the head's input read once and its audio written
once; its weights once a dispatch (:func:`head_weight_bytes`).
"""

from typing import Dict

from harness.flops import F32, _mm

HEAD_KERNEL = 7
PQMF_TAPS = 62


def _shape(cfg: Dict, frames: int):
    """(head steps T, last stage channels, bands, bins, n_fft, iSTFT
    hop)."""
    up = 1
    for rate in cfg["upsample_rates"]:
        up *= rate
    ch = cfg["upsample_initial_channel"] >> len(cfg["upsample_rates"])
    n_fft = cfg["istft_n_fft"]
    return (frames * up, ch, cfg["istft_bands"], n_fft // 2 + 1, n_fft,
            cfg["istft_hop"])


def head(cfg: Dict, frames: int) -> float:
    """The head's operations: the magnitude and phase convs, the inverse
    DFT of every band's frames (the silent one appended included), the
    overlap-add and the PQMF synthesis bank."""
    t, ch, bands, bins, n_fft, hop = _shape(cfg, frames)
    heads = 2 * _mm(t, bands * bins, ch * HEAD_KERNEL)
    idft = _mm((t + 1) * bands, n_fft, 2 * bins)
    ola = 2.0 * (t + 1) * bands * n_fft
    pqmf = _mm(t * hop, 1, bands * (PQMF_TAPS + 1))
    return heads + idft + ola + pqmf


def head_bytes(cfg: Dict, frames: int) -> float:
    """The head's activations: the last stage's output in, the audio
    out."""
    t, ch, bands, _, _, hop = _shape(cfg, frames)
    return (t * ch + t * hop * bands) * F32


def head_weight_bytes(cfg: Dict) -> int:
    """The two heads' weights and biases and the PQMF filters."""
    _, ch, bands, bins, _, _ = _shape(cfg, 0)
    return (2 * (bands * bins * ch * HEAD_KERNEL + bands * bins)
            + bands * (PQMF_TAPS + 1)) * F32
