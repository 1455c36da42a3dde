"""A voice's weights, made on the device from the seed.

:func:`layout` lists every tensor of a piper VITS generator under its
state-dict name (the names piper's ONNX export keeps), with its shape and
the scale it is drawn at; :func:`make` draws all of them in one call of a
``torch.Generator`` on the device and cuts the draw into tensors. The
scales follow VITS's initialisers (a conv's weight at 1/sqrt(fan-in), the
HiFi-GAN convs' weight_v at the config's ``init.decoder_weight_v_std``
(VITS: 0.01), embeddings at 1/sqrt(width)), with two
changes that make every part of the model do work: the projections VITS
starts at zero (the coupling flows' ``post``, the spline flows' ``proj``,
the elementwise affine) get small random values, and each weight-norm
gain is drawn around the norm of its direction, so a conv's weight has
the scale of its ``weight_v``.

"""

import math
from typing import Dict, List, Tuple

import torch

# name, shape, mean, std
Leaf = Tuple[str, Tuple[int, ...], float, float]

# the zero-initialised projections of the flows, drawn at this share of
# 1/sqrt(fan-in)
ZERO_INIT_SHARE = 0.3


def _conv(out: List[Leaf], name: str, o: int, i: int, k: int,
          bias: bool = True, share: float = 1.0) -> None:
    """A conv at 1/sqrt(fan-in) times ``share``; ``share`` 0 is VITS's
    zero-initialised projection, bias and all."""
    std = share / math.sqrt(i * k)
    out.append((name + ".weight", (o, i, k), 0.0, std))
    if bias:
        out.append((name + ".bias", (o,), 0.0,
                    (share > 0) / math.sqrt(3 * i * k)))


def _wn_conv(out: List[Leaf], name: str, o: int, i: int, k: int,
             v_std: float = None, bias: bool = True,
             transposed: bool = False) -> None:
    """A weight-normalised conv: weight_v, weight_g (around ||v||) and the
    bias. A transposed conv's weight is [in, out, k] and its gain [in]."""
    fan = i * k
    v_std = 1.0 / math.sqrt(fan) if v_std is None else v_std
    shape = (i, o, k) if transposed else (o, i, k)
    out.append((name + ".weight_v", shape, 0.0, v_std))
    norm = v_std * math.sqrt(shape[1] * shape[2])
    out.append((name + ".weight_g", (shape[0], 1, 1), norm, 0.05 * norm))
    if bias:
        out.append((name + ".bias", (o,), 0.0, 1.0 / math.sqrt(3 * fan)))


def _norm(out: List[Leaf], name: str, c: int, spread: float) -> None:
    out.append((f"{name}.gamma", (c,), 1.0, spread))
    out.append((f"{name}.beta", (c,), 0.0, spread))


def _dds(out: List[Leaf], name: str, c: int, k: int, layers: int,
         spread: float) -> None:
    for i in range(layers):
        _conv(out, f"{name}.convs_sep.{i}", c, 1, k)
        _conv(out, f"{name}.convs_1x1.{i}", c, c, 1)
        _norm(out, f"{name}.norms_1.{i}", c, spread)
        _norm(out, f"{name}.norms_2.{i}", c, spread)


def _wavenet(out: List[Leaf], name: str, h: int, k: int,
             layers: int) -> None:
    for i in range(layers):
        _wn_conv(out, f"{name}.in_layers.{i}", 2 * h, h, k)
    for i in range(layers):
        _wn_conv(out, f"{name}.res_skip_layers.{i}",
                 2 * h if i < layers - 1 else h, h, 1)


def layout(cfg: dict, vits_init: bool = False) -> List[Leaf]:
    """Every generator tensor of a single-speaker HiFi-GAN VITS voice.

    ``vits_init``: the scales VITS trains from (zero-initialised flow and
    spline projections, unit layer norms, the HiFi-GAN convs' weight_v at
    0.01); otherwise a voice's: every part does work and the decoder's
    weight_v is at the config's ``init.decoder_weight_v_std``."""
    h, f, c = (cfg["hidden_channels"], cfg["filter_channels"],
               cfg["inter_channels"])
    zero = 0.0 if vits_init else ZERO_INIT_SHARE
    spread = 0.0 if vits_init else 0.1  # of the norms and the affine flow
    out: List[Leaf] = [("enc_p.emb.weight", (cfg["n_vocab"], h), 0.0,
                        h ** -0.5)]
    kc = h // cfg["n_heads"]
    for i in range(cfg["n_layers"]):
        a = f"enc_p.encoder.attn_layers.{i}"
        for p in ("q", "k", "v", "o"):
            _conv(out, f"{a}.conv_{p}", h, h, 1)
        out.append((a + ".emb_rel_k", (1, 9, kc), 0.0, kc ** -0.5))
        out.append((a + ".emb_rel_v", (1, 9, kc), 0.0, kc ** -0.5))
        _norm(out, f"enc_p.encoder.norm_layers_1.{i}", h, spread)
        k = cfg["kernel_size"]
        _conv(out, f"enc_p.encoder.ffn_layers.{i}.conv_1", f, h, k)
        _conv(out, f"enc_p.encoder.ffn_layers.{i}.conv_2", h, f, k)
        _norm(out, f"enc_p.encoder.norm_layers_2.{i}", h, spread)
    _conv(out, "enc_p.proj", 2 * c, h, 1)

    # the HiFi-GAN convs' weight_v scale sets the output's loudness
    v_dec = 0.01 if vits_init else cfg["init"]["decoder_weight_v_std"]
    u = cfg["upsample_initial_channel"]
    _conv(out, "dec.conv_pre", u, c, 7)
    ch = u
    n_k = len(cfg["resblock_kernel_sizes"])
    for i, k in enumerate(cfg["upsample_kernel_sizes"]):
        _wn_conv(out, f"dec.ups.{i}", ch // 2, ch, k, v_std=v_dec,
                 transposed=True)
        ch //= 2
        for j, (rk, dils) in enumerate(zip(cfg["resblock_kernel_sizes"],
                                           cfg["resblock_dilation_sizes"])):
            r = f"dec.resblocks.{i * n_k + j}"
            lists = (("convs1", "convs2") if cfg["resblock"] == "1"
                     else ("convs",))
            for name in lists:
                for n in range(len(dils)):
                    _wn_conv(out, f"{r}.{name}.{n}", ch, ch, rk,
                             v_std=v_dec)
    _conv(out, "dec.conv_post", 1, ch, 7, bias=False)

    _conv(out, "enc_q.pre", h, cfg["spec_channels"], 1)
    _wavenet(out, "enc_q.enc", h, 5, 16)
    _conv(out, "enc_q.proj", 2 * c, h, 1)

    for i in range(4):
        p = f"flow.flows.{2 * i}"
        _conv(out, p + ".pre", h, c // 2, 1)
        _wavenet(out, p + ".enc", h, 5, 4)
        _conv(out, p + ".post", c // 2, h, 1, share=zero)

    fc = h  # the SDP's filter channels are its input's (VITS)
    _conv(out, "dp.pre", fc, h, 1)
    _conv(out, "dp.proj", fc, fc, 1)
    _dds(out, "dp.convs", fc, 3, 3, spread)
    _conv(out, "dp.post_pre", fc, 1, 1)
    _conv(out, "dp.post_proj", fc, fc, 1)
    _dds(out, "dp.post_convs", fc, 3, 3, spread)
    for head in ("flows", "post_flows"):
        out.append((f"dp.{head}.0.m", (2, 1), 0.0, spread))
        out.append((f"dp.{head}.0.logs", (2, 1), 0.0, spread))
        for t in (1, 3, 5, 7):
            p = f"dp.{head}.{t}"
            _conv(out, p + ".pre", fc, 1, 1)
            _dds(out, p + ".convs", fc, 3, 3, spread)
            _conv(out, p + ".proj", 29, fc, 1, share=zero)
    return out


def make(leaves: List[Leaf], seed: int, device,
         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The leaves drawn from ``seed`` on ``device``: one normal draw for
    all of them, cut and scaled leaf by leaf (views of one buffer)."""
    sizes = [math.prod(shape) for _, shape, _, _ in leaves]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    counts = torch.tensor(sizes, device=device)
    mean, std = torch.tensor([[m, s] for _, _, m, s in leaves],
                             device=device).repeat_interleave(counts,
                                                              dim=0).unbind(1)
    flat = (flat * std + mean).to(dtype)
    out, start = {}, 0
    for n, (name, shape, _, _) in zip(sizes, leaves):
        out[name] = flat[start:start + n].view(shape)
        start += n
    return out
