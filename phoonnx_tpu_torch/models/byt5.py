"""ByT5/T5 encoder-decoder for neural G2P, on a torch device.

Port of ``phoonnx_tpu/models/byt5.py``. The reference executes the ByT5
G2P ONNX model with onnxruntime, re-running the full decoder for every
generated token (phoonnx/phonemizers/mul.py:201-230 — up to 512
session.run calls per chunk). This implementation runs the same
checkpoints natively: the encoder is one pass of torch ops and the greedy
decode keeps a KV cache, so each step costs one incremental layer pass
instead of a full re-encode.

Weights import by name from the HF/torch parameter naming preserved in ONNX
exports (``encoder.block.N.layer.0.SelfAttention.q.weight``...); the
architecture config (layers, d_model, heads, FFN type) is inferred from
tensor shapes.

Numerics follow the JAX module's dtypes: mixed operands promote as JAX
promotes them (bfloat16 with float32 gives float32), and the products the
JAX module accumulates with ``preferred_element_type=float32`` (attention
scores and values, the logits) take float32 operands here, where every
bfloat16 product is exact. The KV cache and the decoder's activations
between layers stay in the parameter dtype.

Differences from the JAX module, none of which changes an output:

* **The loop.** JAX's ``lax.while_loop`` stops on the device once every
  row has finished. Here the host drives the steps and reads the
  ``finished`` flags every :data:`CHECK_EVERY` steps, not after each
  token; a finished row emits ``pad_id`` and keeps its length, so the
  extra steps change nothing.
* **Relative-position buckets** are computed on the host (integer index
  tables, uploaded once a call), so every device gathers the same
  buckets; the decoder's bias is built once for the whole step budget and
  each step takes its row.
* **No compile cache.** ``_decode_for`` keeps the JAX engine's
  power-of-two step budgets and its ``_decode_cache`` keys; its values are
  plain callables.
"""

import logging
import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from phoonnx_tpu_torch.infer.engine import DTYPES, _prec_scope, resolve_device

LOG = logging.getLogger(__name__)

# decode steps between host reads of the rows' finished flags
CHECK_EVERY = 8


@dataclass(frozen=True)
class T5Config:
    vocab_size: int
    d_model: int
    d_kv: int
    d_ff: int
    num_heads: int
    num_encoder_layers: int
    num_decoder_layers: int
    relative_buckets: int = 32
    relative_max_distance: int = 128
    gated_ffn: bool = True
    tie_word_embeddings: bool = False
    layer_norm_eps: float = 1e-6
    pad_id: int = 0
    eos_id: int = 1


# ---------------------------------------------------------------------------
# Weight import
# ---------------------------------------------------------------------------


def config_from_flat(named: Mapping[str, np.ndarray]) -> T5Config:
    shapes = {k: tuple(np.asarray(v).shape) for k, v in named.items()}

    def find(key):
        return shapes.get(key)

    vocab, d_model = find("shared.weight")
    q = find("encoder.block.0.layer.0.SelfAttention.q.weight")
    inner = q[0]
    rel = find(
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    )
    relative_buckets, num_heads = rel
    d_kv = inner // num_heads
    gated = "encoder.block.0.layer.1.DenseReluDense.wi_0.weight" in shapes
    ff_key = ("encoder.block.0.layer.1.DenseReluDense.wi_0.weight"
              if gated else "encoder.block.0.layer.1.DenseReluDense.wi.weight")
    d_ff = find(ff_key)[0]

    def count_layers(prefix):
        n = 0
        while f"{prefix}.block.{n}.layer.0.SelfAttention.q.weight" in shapes:
            n += 1
        return n

    return T5Config(
        vocab_size=vocab,
        d_model=d_model,
        d_kv=d_kv,
        d_ff=d_ff,
        num_heads=num_heads,
        num_encoder_layers=count_layers("encoder"),
        num_decoder_layers=count_layers("decoder"),
        relative_buckets=relative_buckets,
        gated_ffn=gated,
        tie_word_embeddings="lm_head.weight" not in shapes,
    )


def params_from_flat(named: Mapping[str, np.ndarray],
                     device=None) -> Dict[str, Any]:
    """Nest HF-named arrays into a tree of tensors on ``device`` (None
    means the GPU). Kept in HF layout: linear weights are [out, in] and
    applied as x @ W^T."""
    device = resolve_device(device)
    tree: Dict[str, Any] = {}
    for name, value in named.items():
        parts = name.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.from_numpy(
            np.array(value, order="C")).to(device)
    return tree


def random_flat(cfg: T5Config, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random weights of ``cfg``'s geometry in HF naming (float32 numpy,
    no ``transformers`` needed), as the weight import reads them from an
    ONNX export. The scales are those ``transformers`` initialises a T5
    with (``T5PreTrainedModel._init_weights``): q N(0, 1/(d_model d_kv)),
    k and v N(0, 1/d_model), o N(0, 1/(heads d_kv)), wi N(0, 1/d_model),
    wo N(0, 1/d_ff), the relative position tables N(0, 1/d_model), the
    embeddings and the head N(0, 1); the layer norms near 1 (N(1, 0.1),
    so that a norm's weight shows)."""
    rng = np.random.default_rng(seed)
    inner = cfg.num_heads * cfg.d_kv
    named: Dict[str, np.ndarray] = {}

    def put(name, shape, var):
        arr = rng.standard_normal(shape, dtype=np.float32)
        arr *= np.float32(var ** 0.5)
        named[name] = arr

    def norm(name):
        arr = rng.standard_normal(cfg.d_model, dtype=np.float32)
        named[f"{name}.weight"] = np.float32(1.0) + np.float32(0.1) * arr

    put("shared.weight", (cfg.vocab_size, cfg.d_model), 1.0)
    for stack, n_layers in (("encoder", cfg.num_encoder_layers),
                            ("decoder", cfg.num_decoder_layers)):
        for i in range(n_layers):
            blk = f"{stack}.block.{i}.layer"
            attns = ["0.SelfAttention"]
            if stack == "decoder":
                attns.append("1.EncDecAttention")
            for attn in attns:
                put(f"{blk}.{attn}.q.weight", (inner, cfg.d_model),
                    1.0 / (cfg.d_model * cfg.d_kv))
                for proj in "kv":
                    put(f"{blk}.{attn}.{proj}.weight", (inner, cfg.d_model),
                        1.0 / cfg.d_model)
                put(f"{blk}.{attn}.o.weight", (cfg.d_model, inner),
                    1.0 / inner)
                norm(f"{blk}.{attn.split('.')[0]}.layer_norm")
            if i == 0:
                put(f"{blk}.0.SelfAttention.relative_attention_bias.weight",
                    (cfg.relative_buckets, cfg.num_heads), 1.0 / cfg.d_model)
            ff = f"{blk}.{len(attns)}.DenseReluDense"
            for wi in (("wi_0", "wi_1") if cfg.gated_ffn else ("wi",)):
                put(f"{ff}.{wi}.weight", (cfg.d_ff, cfg.d_model),
                    1.0 / cfg.d_model)
            put(f"{ff}.wo.weight", (cfg.d_model, cfg.d_ff), 1.0 / cfg.d_ff)
            norm(f"{blk}.{len(attns)}.layer_norm")
        norm(f"{stack}.final_layer_norm")
    if not cfg.tie_word_embeddings:
        put("lm_head.weight", (cfg.vocab_size, cfg.d_model), 1.0)
    return named


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the dtype JAX promotes the two to."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dtype), b.to(dtype))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated and returned in float32 (JAX's
    ``preferred_element_type=jnp.float32``)."""
    return torch.matmul(a.float(), b.float())


def _rms_norm(weight: torch.Tensor, x: torch.Tensor,
              eps: float) -> torch.Tensor:
    variance = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(variance + eps)).to(x.dtype) * weight


def _linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return _mm(x, p["weight"].T)


def _relative_bucket(relative_position: torch.Tensor, bidirectional: bool,
                     num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5 relative position bucketing (log-spaced beyond max_exact)."""
    bucket = torch.zeros_like(relative_position)
    if bidirectional:
        num_buckets //= 2
        bucket = bucket + (relative_position > 0).to(
            relative_position.dtype) * num_buckets
        position = relative_position.abs()
    else:
        position = -torch.clamp(relative_position, max=0)

    max_exact = num_buckets // 2
    is_small = position < max_exact
    large = max_exact + (
        torch.log(position.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(position.dtype)
    large = torch.clamp(large, max=num_buckets - 1)
    return bucket + torch.where(is_small, position, large)


def _position_bias(rel_table: torch.Tensor, q_len: int, k_len: int,
                   bidirectional: bool, cfg: T5Config,
                   q_offset: int = 0) -> torch.Tensor:
    """[1, H, q_len, k_len] additive attention bias (buckets computed on
    the host, gathered on the table's device)."""
    context = torch.arange(q_len)[:, None] + q_offset
    memory = torch.arange(k_len)[None, :]
    buckets = _relative_bucket(
        memory - context, bidirectional, cfg.relative_buckets,
        cfg.relative_max_distance,
    )
    bias = rel_table[buckets.to(rel_table.device)]  # [q, k, H]
    return bias.permute(2, 0, 1)[None]


def _heads(x: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """[B, T, H * d_kv] -> [B, H, T, d_kv]."""
    b, t, _ = x.shape
    return x.reshape(b, t, cfg.num_heads, cfg.d_kv).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, d_kv] -> [B, T, H * d_kv]."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _attention(p, x: torch.Tensor, kv: torch.Tensor, cfg: T5Config,
               bias: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    q = _heads(_linear(p["q"], x), cfg)
    k = _heads(_linear(p["k"], kv), cfg)
    v = _heads(_linear(p["v"], kv), cfg)

    scores = _mm_f32(q, k.transpose(-1, -2))
    if bias is not None:
        scores = scores + bias
    if mask is not None:
        scores = torch.where(mask, scores, -1e9)
    weights = torch.softmax(scores, dim=-1)
    return _linear(p["o"], _merge(_mm_f32(weights, v)))


def _ffn(p, x: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    if cfg.gated_ffn:
        # HF "gated-gelu" is the tanh-approximate (gelu_new) variant
        gate = torch.nn.functional.gelu(_linear(p["wi_0"], x),
                                        approximate="tanh")
        hidden = gate * _linear(p["wi_1"], x)
    else:
        hidden = torch.relu(_linear(p["wi"], x))
    return _linear(p["wo"], hidden)


def encode(params, cfg: T5Config, input_ids: torch.Tensor,
           attention_mask: torch.Tensor) -> torch.Tensor:
    """input_ids [B, T] -> encoder hidden states [B, T, D]."""
    enc = params["encoder"]
    x = params["shared"]["weight"][input_ids.long()]
    t = input_ids.shape[1]
    rel_table = enc["block"]["0"]["layer"]["0"]["SelfAttention"][
        "relative_attention_bias"]["weight"]
    bias = _position_bias(rel_table, t, t, True, cfg)
    mask = attention_mask[:, None, None, :] > 0

    for i in range(cfg.num_encoder_layers):
        block = enc["block"][str(i)]["layer"]
        attn = block["0"]
        h = _rms_norm(attn["layer_norm"]["weight"], x, cfg.layer_norm_eps)
        x = x + _attention(attn["SelfAttention"], h, h, cfg, bias=bias,
                           mask=mask)
        ff = block["1"]
        h = _rms_norm(ff["layer_norm"]["weight"], x, cfg.layer_norm_eps)
        x = x + _ffn(ff["DenseReluDense"], h, cfg)
    return _rms_norm(enc["final_layer_norm"]["weight"], x, cfg.layer_norm_eps)


def _logits(params, cfg: T5Config, x: torch.Tensor, f32: bool):
    """The head: the tied embedding (scaled) or ``lm_head``; ``f32``
    accumulates in float32 as the decode loop does."""
    mm = _mm_f32 if f32 else _mm
    if cfg.tie_word_embeddings:
        return mm(x * (cfg.d_model ** -0.5), params["shared"]["weight"].T)
    return mm(x, params["lm_head"]["weight"].T)


def _decoder_logits_full(params, cfg: T5Config, decoder_ids: torch.Tensor,
                         encoder_out: torch.Tensor,
                         encoder_mask: torch.Tensor) -> torch.Tensor:
    """Full (non-incremental) decoder pass -> logits [B, T_dec, V]."""
    dec = params["decoder"]
    x = params["shared"]["weight"][decoder_ids.long()]
    t = decoder_ids.shape[1]
    rel_table = dec["block"]["0"]["layer"]["0"]["SelfAttention"][
        "relative_attention_bias"]["weight"]
    self_bias = _position_bias(rel_table, t, t, False, cfg)
    causal = torch.ones((t, t), dtype=torch.bool,
                        device=x.device).tril()[None, None]
    cross_mask = encoder_mask[:, None, None, :] > 0

    for i in range(cfg.num_decoder_layers):
        block = dec["block"][str(i)]["layer"]
        attn = block["0"]
        h = _rms_norm(attn["layer_norm"]["weight"], x, cfg.layer_norm_eps)
        x = x + _attention(attn["SelfAttention"], h, h, cfg, bias=self_bias,
                           mask=causal)
        cross = block["1"]
        h = _rms_norm(cross["layer_norm"]["weight"], x, cfg.layer_norm_eps)
        x = x + _attention(cross["EncDecAttention"], h, encoder_out, cfg,
                           mask=cross_mask)
        ff = block["2"]
        h = _rms_norm(ff["layer_norm"]["weight"], x, cfg.layer_norm_eps)
        x = x + _ffn(ff["DenseReluDense"], h, cfg)

    x = _rms_norm(dec["final_layer_norm"]["weight"], x, cfg.layer_norm_eps)
    return _logits(params, cfg, x, f32=False)


def greedy_decode(params, cfg: T5Config, input_ids: torch.Tensor,
                  attention_mask: torch.Tensor, max_length: int = 512,
                  stats: Optional[Dict[str, Any]] = None,
                  keep_logits: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached greedy decode; returns (tokens [B, max_length], lengths).

    Decoder starts from pad (0); generation stops at eos (1), matching the
    reference's loop (mul.py:181-233). ``lengths[row]`` counts the
    generated tokens before the EOS marker, so ``tokens[row, :length]``
    is the pre-EOS sequence. ``stats``, when given, receives the steps run
    and the host reads of the finished flags, and with ``keep_logits``
    each step's float32 logits as ``stats["logits"]`` [steps, B, V] on the
    device (to compare two decodes step by step).
    """
    b = input_ids.shape[0]
    encoder_out = encode(params, cfg, input_ids, attention_mask)
    dev = encoder_out.device

    dec = params["decoder"]
    n_layers = cfg.num_decoder_layers
    rel_table = dec["block"]["0"]["layer"]["0"]["SelfAttention"][
        "relative_attention_bias"]["weight"]
    shared = params["shared"]["weight"]

    # Precompute cross-attention K/V once per layer.
    cross_kv = []
    for i in range(n_layers):
        attn = dec["block"][str(i)]["layer"]["1"]["EncDecAttention"]
        cross_kv.append((_heads(_linear(attn["k"], encoder_out), cfg),
                         _heads(_linear(attn["v"], encoder_out), cfg)))
    cross_mask = attention_mask[:, None, None, :] > 0

    # the decoder shares ONE relative-position table: the bias of every
    # step's query position, built once; step pos takes row pos
    self_bias = _position_bias(rel_table, max_length, max_length, False, cfg)
    causal = torch.ones((max_length, max_length), dtype=torch.bool,
                        device=dev).tril()

    # KV cache in the parameter dtype (bf16 halves per-step cache reads)
    cache_dtype = shared.dtype
    self_k = torch.zeros((n_layers, b, cfg.num_heads, max_length, cfg.d_kv),
                         dtype=cache_dtype, device=dev)
    self_v = torch.zeros_like(self_k)
    tokens = torch.zeros((b, max_length + 1), dtype=torch.long,
                         device=dev)  # slot 0 = start pad
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
    kept: List[torch.Tensor] = []

    def step(pos: int):
        nonlocal finished, lengths
        x = shared[tokens[:, pos]][:, None, :]
        bias = self_bias[:, :, pos:pos + 1]
        valid = causal[pos]
        for i in range(n_layers):
            block = dec["block"][str(i)]["layer"]
            attn = block["0"]
            h = _rms_norm(attn["layer_norm"]["weight"], x, cfg.layer_norm_eps)
            sa = attn["SelfAttention"]
            q = _heads(_linear(sa["q"], h), cfg)
            self_k[i, :, :, pos] = _heads(_linear(sa["k"], h), cfg)[:, :, 0]
            self_v[i, :, :, pos] = _heads(_linear(sa["v"], h), cfg)[:, :, 0]

            scores = _mm_f32(q, self_k[i].transpose(-1, -2))
            scores = torch.where(valid, scores + bias, -1e9)
            weights = torch.softmax(scores, dim=-1)
            x = x + _linear(sa["o"], _merge(_mm_f32(weights, self_v[i])))

            cross = block["1"]
            h = _rms_norm(cross["layer_norm"]["weight"], x,
                          cfg.layer_norm_eps)
            ca = cross["EncDecAttention"]
            ck, cv = cross_kv[i]
            scores = _mm_f32(_heads(_linear(ca["q"], h), cfg),
                             ck.transpose(-1, -2))
            scores = torch.where(cross_mask, scores, -1e9)
            weights = torch.softmax(scores, dim=-1)
            x = x + _linear(ca["o"], _merge(_mm_f32(weights, cv)))

            ff = block["2"]
            h = _rms_norm(ff["layer_norm"]["weight"], x, cfg.layer_norm_eps)
            # keep activations in the parameter dtype (the f32-accumulated
            # attention outputs would otherwise upcast every later layer)
            x = (x + _ffn(ff["DenseReluDense"], h, cfg)).to(cache_dtype)

        x = _rms_norm(dec["final_layer_norm"]["weight"], x,
                      cfg.layer_norm_eps)
        logits = _logits(params, cfg, x, f32=True)
        if keep_logits:
            kept.append(logits[:, 0])
        next_token = torch.argmax(logits[:, 0], dim=-1)
        next_token = torch.where(finished, cfg.pad_id, next_token)
        tokens[:, pos + 1] = next_token
        eos = next_token == cfg.eos_id
        # lengths count generated tokens BEFORE the EOS marker
        lengths = torch.where(finished, lengths,
                              pos + 1 - eos.to(torch.int32))
        finished = finished | eos

    pos, reads = 0, 0
    while pos < max_length:
        step(pos)
        pos += 1
        if pos % CHECK_EVERY == 0 and pos < max_length:
            reads += 1
            if bool(finished.all()):
                break
    if stats is not None:
        stats.update(steps=pos, reads=reads)
        if keep_logits:
            stats["logits"] = torch.stack(kept)
    return tokens[:, 1:], lengths


class ByT5Engine:
    """Loaded ByT5 G2P model with a KV-cached greedy decoder on ``device``.

    dtype: "bfloat16" halves the per-step memory traffic (autoregressive
    decode is weight/KV-bandwidth bound); attention scores and logits
    still accumulate in f32 before the argmax.

    max_length_factor: every decode step attends over the FULL KV
    window, so the per-step cost scales with the step budget, not the
    tokens actually generated. The budget is therefore bucketed to
    ``max(64, factor * input_bucket)`` (capped at ``max_length``) —
    G2P outputs are byte strings a small multiple of their input's
    length, so factor 4 is generous (the reference always runs a
    512-slot decoder, mul.py:201). None restores the flat budget.

    device: None means the GPU (and raises without one); ``"cpu"`` runs
    the same ops on the host's torch. The products run with TF32 off.
    ``last_decode`` holds the latest decode's steps and host reads.
    """

    def __init__(self, params, cfg: T5Config, max_length: int = 512,
                 input_buckets=(32, 64, 128, 256, 512),
                 dtype: str = "float32",
                 max_length_factor: Optional[int] = 4,
                 device=None):
        if dtype not in DTYPES:
            raise ValueError(f"dtype {dtype!r}: one of {sorted(DTYPES)}")
        self.device = resolve_device(device)
        cast = DTYPES[dtype]
        self.params = _tree_map(
            lambda t: t.to(self.device, cast) if t.is_floating_point()
            else t.to(self.device), params)
        self.cfg = cfg
        self.max_length = max_length
        self.input_buckets = input_buckets
        self.max_length_factor = max_length_factor
        self._decode_cache = {}
        self.last_decode: Dict[str, int] = {}

    def _decode_for(self, input_bucket: int):
        """Decode callable with a bucketed step budget."""
        if self.max_length_factor is None:
            dec_len = self.max_length
        else:
            want = max(64, self.max_length_factor * input_bucket)
            dec_len = 64
            while dec_len < want:
                dec_len *= 2
            dec_len = min(dec_len, self.max_length)
        if dec_len not in self._decode_cache:
            self._decode_cache[dec_len] = partial(
                greedy_decode, cfg=self.cfg, max_length=dec_len)
        return self._decode_cache[dec_len]

    @classmethod
    def from_onnx(cls, model_path: str, device=None, **kw) -> "ByT5Engine":
        from phoonnx_tpu_torch.onnx.reader import read_onnx

        device = resolve_device(device)
        model = read_onnx(model_path)
        if not model.initializers:
            raise FileNotFoundError(
                f"no initializers found in {model_path}"
            )
        named = model.initializers
        cfg = config_from_flat(named)
        return cls(params_from_flat(named, device), cfg, device=device, **kw)

    @classmethod
    def from_flat(cls, named: Mapping[str, np.ndarray], device=None,
                  **kw) -> "ByT5Engine":
        device = resolve_device(device)
        return cls(params_from_flat(named, device), config_from_flat(named),
                   device=device, **kw)

    def greedy_decode(self, input_ids: List[int]) -> List[int]:
        """One utterance byte-id list -> generated token ids (pre-EOS)."""
        return self.greedy_decode_batch([input_ids])[0]

    def greedy_decode_batch(self, batch_ids: List[List[int]]
                            ) -> List[List[int]]:
        """Batched greedy decode over padded inputs.

        The per-row ``finished`` handling in the decode loop keeps short
        sequences padded after their EOS, so e.g. Charsiu's word-by-word
        phonemization runs as ONE batched decode instead of one decode per
        word (the reference loops a full onnxruntime decoder per word,
        mul.py:286-288).
        """
        length = max(len(ids) for ids in batch_ids)
        bucket = next(
            (b for b in self.input_buckets if length <= b),
            self.input_buckets[-1],
        )
        if length > bucket:
            LOG.warning(
                "ByT5 input of %d byte ids exceeds the largest input "
                "bucket (%d); the tail is truncated — chunk the text "
                "upstream for full coverage", length, bucket,
            )
        batch = len(batch_ids)
        # pad the batch dimension to a power of two so Charsiu-style
        # word batches (one per sentence, any size) hit a handful of
        # shapes instead of one per word count; the padding repeats row 0
        # so the extra lanes terminate like real data
        lanes = 1
        while lanes < batch:
            lanes *= 2
        ids = np.zeros((lanes, bucket), np.int64)
        mask = np.zeros((lanes, bucket), np.int64)
        for row in range(lanes):
            utt = batch_ids[row] if row < batch else batch_ids[0]
            take = min(len(utt), bucket)
            ids[row, :take] = utt[:take]
            mask[row, :take] = 1
        stats: Dict[str, int] = {}
        with _prec_scope(None), torch.inference_mode():
            tokens, lengths = self._decode_for(bucket)(
                self.params, input_ids=torch.from_numpy(ids).to(self.device),
                attention_mask=torch.from_numpy(mask).to(self.device),
                stats=stats,
            )
            # one read: the lengths ride as the last column
            out = torch.cat([tokens, lengths[:, None].long()], 1).cpu()
        stats["reads"] += 1
        self.last_decode = stats
        out = out.numpy()
        return [
            [int(t) for t in out[row, : int(out[row, -1])]]
            for row in range(batch)
        ]
