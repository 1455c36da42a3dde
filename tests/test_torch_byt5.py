"""The port's ByT5 G2P model against the JAX package's, on the CPU.

``phoonnx_tpu_torch/models/byt5.py`` is held to ``phoonnx_tpu/models/byt5.py``
at ``tests/test_byt5.py``'s widths, on the same weights: drawn with numpy
in HF naming (``byt5.random_flat``; no ``transformers``), passed to both.
f32: the encoder and the teacher-forced logits within 1e-5 of the peak,
greedy tokens and lengths equal. bf16: the first step's logits within one
bf16 step of the peak, tokens equal up to the reference's first near tie
(``chip_smoke.near_tie_split``).
"""

import logging
from dataclasses import asdict

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from phoonnx_tpu.models import byt5 as jbyt5
from phoonnx_tpu_torch.models import byt5

from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

CFG = byt5.T5Config(vocab_size=384, d_model=32, d_kv=16, d_ff=64,
                    num_heads=2, num_encoder_layers=2, num_decoder_layers=2)
VARIANTS = {
    "gated": CFG,
    "relu": byt5.T5Config(**{**asdict(CFG), "gated_ffn": False}),
    "tied": byt5.T5Config(**{**asdict(CFG), "tie_word_embeddings": True}),
}
TOL = 1e-5
# the EOS row of lm_head scaled: rows finish after 3, 6 and 3 tokens and
# one runs to the budget (ENDS); the larger scale ends every row within
# the first 8 steps
ENDS, ALL_END = 2.0, 4.0
SEQS = [[10, 45, 99, 1], [7, 8, 1], [200, 150, 90, 60, 30, 1],
        [33, 34, 35, 36, 1]]


def named_of(cfg, eos_scale=1.0, seed=0):
    named = byt5.random_flat(cfg, seed)
    head = "shared.weight" if cfg.tie_word_embeddings else "lm_head.weight"
    named[head][cfg.eos_id] *= eos_scale
    return named


def engines(named, **kw):
    kw = {"max_length": 24, "input_buckets": (16,), **kw}
    return (jbyt5.ByT5Engine.from_flat(named, **kw),
            byt5.ByT5Engine.from_flat(named, device="cpu", **kw))


@pytest.fixture(scope="module")
def pair():
    return engines(named_of(CFG, ENDS))


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(1.0, np.abs(want).max()))


def inputs():
    ids = np.array([[10, 45, 99, 200, 7, 1, 0, 0],
                    [5, 17, 254, 1, 0, 0, 0, 0]], np.int64)
    return ids, (np.arange(8)[None] < np.array([[6], [4]])).astype(np.int64)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_config_from_flat(variant):
    cfg = VARIANTS[variant]
    named = byt5.random_flat(cfg)
    assert byt5.config_from_flat(named) == cfg
    assert asdict(byt5.config_from_flat(named)) == asdict(
        jbyt5.config_from_flat(named))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_encoder_and_full_decoder(variant):
    import jax

    cfg = VARIANTS[variant]
    named = byt5.random_flat(cfg, 1)
    jcfg = jbyt5.T5Config(**asdict(cfg))
    tp = byt5.params_from_flat(named, "cpu")
    ids, mask = inputs()
    dec = np.array([[0, 12, 30, 5], [0, 7, 7, 100]], np.int64)

    @jax.jit
    def jax_pass(params, ids, mask, dec):
        enc = jbyt5.encode(params, jcfg, ids, mask)
        return enc, jbyt5._decoder_logits_full(params, jcfg, dec, enc, mask)

    want_enc, want = map(np.asarray, jax_pass(jbyt5.params_from_flat(named),
                                              ids, mask, dec))
    got = byt5.encode(tp, cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    assert rel_err(got, want_enc) <= TOL
    got = byt5._decoder_logits_full(tp, cfg, torch.from_numpy(dec), got,
                                    torch.from_numpy(mask))
    assert got.shape == (2, 4, cfg.vocab_size)
    assert rel_err(got, want) <= TOL


def test_greedy_decode_single(pair):
    jax_eng, eng = pair
    ids = [10, 45, 99, 200, 7, 33, 120, 1]
    assert eng.greedy_decode(ids) == jax_eng.greedy_decode(ids)


def test_greedy_decode_batch_rows_finish_apart(pair):
    """Rows ending after 3, 6 and 3 tokens and one at the budget; three
    rows pad to four lanes by repeating row 0."""
    jax_eng, eng = pair
    want = jax_eng.greedy_decode_batch(SEQS)
    got = eng.greedy_decode_batch(SEQS)
    assert got == want
    assert sorted(len(r) for r in got) == [3, 3, 6, 24]
    assert eng.last_decode == {"steps": 24, "reads": 3}
    assert eng.greedy_decode_batch(SEQS[:3]) == want[:3]
    assert [eng.greedy_decode(s) for s in SEQS] == want


def test_decode_stops_once_every_row_ends():
    """Every row ends within the first steps: the loop stops at the
    first read of the finished flags, lengths as JAX's."""
    jax_eng, eng = engines(named_of(CFG, ALL_END), max_length=64)
    assert eng.greedy_decode_batch(SEQS) == jax_eng.greedy_decode_batch(SEQS)
    assert eng.last_decode == {"steps": byt5.CHECK_EVERY, "reads": 2}


def seq_inputs():
    """SEQS padded as the engines pad them: [4, 16] ids and mask."""
    ids = np.zeros((len(SEQS), 16), np.int64)
    for row, seq in enumerate(SEQS):
        ids[row, :len(seq)] = seq
    return ids, (ids > 0).astype(np.int64)


def test_greedy_decode_tokens_and_lengths_raw(pair):
    """The module function's (tokens, lengths) against JAX's program,
    rows that finished included."""
    jax_eng, eng = pair
    ids, mask = seq_inputs()
    jt, jl = jax_eng._decode_for(16)(jax_eng.params,
                                     input_ids=jnp.asarray(ids),
                                     attention_mask=jnp.asarray(mask))
    with torch.inference_mode():
        tt, tl = byt5.greedy_decode(eng.params, CFG, torch.from_numpy(ids),
                                    torch.from_numpy(mask), max_length=24)
    assert tl.tolist() == np.asarray(jl).tolist()
    for row, n in enumerate(tl.tolist()):
        assert tt[row, :n].tolist() == np.asarray(jt)[row, :n].tolist()


def test_decode_budget_buckets(pair):
    _, eng = pair
    fn16 = eng._decode_for(16)
    assert eng._decode_for(16) is fn16
    assert list(eng._decode_cache) == [24]
    eng2 = byt5.ByT5Engine(eng.params, CFG, max_length=512,
                           input_buckets=(16, 32, 128), device="cpu")
    eng2._decode_for(16)
    eng2._decode_for(128)
    assert sorted(eng2._decode_cache) == [64, 512]
    eng3 = byt5.ByT5Engine(eng.params, CFG, max_length=512,
                           max_length_factor=None, device="cpu")
    eng3._decode_for(16)
    assert list(eng3._decode_cache) == [512]


def test_truncation_warning(pair, caplog):
    jax_eng, eng = pair
    long_ids = list(range(3, 23)) + [1]  # 21 ids > the 16 bucket
    with caplog.at_level(logging.WARNING):
        got = eng.greedy_decode(long_ids)
    assert "exceeds the largest input bucket (16)" in caplog.text
    assert got == jax_eng.greedy_decode(long_ids)


def test_kv_cache_equals_full_decoder():
    """Incremental decode (to the budget) against the full decoder pass
    over its own prefix."""
    eng = engines(named_of(CFG))[1]
    ids = np.array([[5, 17, 254, 1]], np.int64)
    generated = eng.greedy_decode([5, 17, 254, 1])
    assert len(generated) == 24
    mask = torch.ones(1, 4, dtype=torch.long)
    with torch.inference_mode():
        enc = byt5.encode(eng.params, CFG, torch.from_numpy(ids), mask)
        logits = byt5._decoder_logits_full(
            eng.params, CFG, torch.tensor([[0] + generated[:-1]]), enc, mask)
    assert logits.argmax(-1)[0].tolist() == generated


def test_bf16_decode():
    """bf16 weights: the first step's logits within one bf16 step of the
    peak of JAX's; tokens equal up to the reference's first near tie (the
    reference's logits teacher-forced on its own tokens)."""
    import jax

    import chip_smoke

    named = named_of(CFG, ENDS)
    jax_eng, eng = engines(named, dtype="bfloat16")
    assert eng.params["shared"]["weight"].dtype == torch.bfloat16

    @jax.jit
    def jax_logits(params, ids, mask, dec):
        enc = jbyt5.encode(params, CFG, ids, mask)
        return jbyt5._decoder_logits_full(params, CFG, dec, enc, mask)

    want_rows = jax_eng.greedy_decode_batch(SEQS)
    got_rows = eng.greedy_decode_batch(SEQS)
    ids, mask = seq_inputs()
    teacher = np.zeros((len(SEQS), 24), np.int64)
    for row, w in enumerate(want_rows):
        w_ext = (w + [CFG.eos_id])[:24]
        teacher[row, 1:len(w_ext)] = w_ext[:-1]
    ref = np.asarray(jax_logits(jax_eng.params, ids, mask, teacher),
                     np.float32)
    with torch.inference_mode():
        first = byt5._decoder_logits_full(
            eng.params, CFG, torch.from_numpy(teacher[:, :1]),
            byt5.encode(eng.params, CFG, torch.from_numpy(ids),
                        torch.from_numpy(mask)),
            torch.from_numpy(mask)).float()
    step = 2.0 ** -8  # one bf16 step (8 significant bits) of the peak
    assert rel_err(first, ref[:, :1]) <= step
    for row, (w, g) in enumerate(zip(want_rows, got_rows)):
        n = min(len(w) + 1, 24)
        chip_smoke.near_tie_split(w, g, ref[row, :n],
                                  4 * step * np.abs(ref[row]).max(),
                                  CFG.eos_id, "bf16 port vs JAX")


def test_no_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    named = byt5.random_flat(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        byt5.ByT5Engine.from_flat(named)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        byt5.params_from_flat(named)
