"""bf16 synthesis of the iSTFT and multi-band iSTFT micro voices: the
port's ``model.infer`` in bfloat16 against JAX ``infer`` in bfloat16 with
kernel C at their stages (no tail) in interpret mode, as
``tests/test_torch_bf16_path.py`` holds the HiFi-GAN voice.
"""

import pytest

from tests.test_torch_bf16 import make_models
# autouse: the JAX kernels in interpret mode
from tests.test_torch_bf16 import _interpret  # noqa: F401
from tests.test_torch_bf16_path import check_infer_bf16
from tests.test_torch_istft import HPS
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

@pytest.mark.parametrize("family", ["istft", "mb-istft"])
def test_istft_infer_bf16_matches_jax(family):
    """The iSTFT and multi-band iSTFT micro voices in bf16: kernel C at
    their stages (no tail), the spectral heads and the inverse STFT in
    the tensors' type; measured 1.7e-3 and 1.6e-3 (bound PATH_TOL)."""
    hp = HPS[family]
    jp, tp, thp = make_models(hp, 2)
    check_infer_bf16(jp, tp, hp, thp, 0, [11, 6], t_x=11, max_frames=96)
