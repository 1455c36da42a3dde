"""Model operations and bytes of VITS, in closed form.

A plain-Python copy of the repository's analytic counts
(``phoonnx_tpu/flops.py``, whose conventions it keeps: multiply-adds x 2
of the dense linear algebra, elementwise work left out, transposed convs
counted as T_in x I x O x K), over a config dict, with the bytes that the
roofline of kernels B and C needs beside the operations.
"""

from typing import Dict, List

REL_WINDOW = 4
F32 = 4


def _mm(m: float, n: float, k: float) -> float:
    return 2.0 * m * n * k


def text_encoder(cfg: Dict, t_text: int) -> float:
    t, h, f = t_text, cfg["hidden_channels"], cfg["filter_channels"]
    per_layer = (4 * _mm(t, h, h) + 2 * _mm(t, t, h)
                 + 2 * _mm(t, 2 * REL_WINDOW + 1, h)
                 + 2 * _mm(t, f, h * cfg["kernel_size"]))
    return cfg["n_layers"] * per_layer + _mm(t, 2 * cfg["inter_channels"], h)


def _dds(t: int, ch: int, kernel: int, n_layers: int) -> float:
    return n_layers * (2.0 * t * ch * kernel + _mm(t, ch, ch))


def sdp_reverse(cfg: Dict, t_text: int) -> float:
    t, h, k = t_text, cfg["hidden_channels"], cfg["kernel_size"]
    trunk = _mm(t, h, h) + _dds(t, h, k, 3) + _mm(t, h, h)
    per_cf = _mm(t, h, 1) + _dds(t, h, k, 3) + _mm(t, 29, h)
    return trunk + 4 * per_cf


def flow(cfg: Dict, frames: int) -> float:
    """The residual coupling flow, one direction (kernel B's work)."""
    y, h, half = frames, cfg["hidden_channels"], cfg["inter_channels"] // 2
    per_wn = _mm(y, 2 * h, h * 5) + _mm(y, 2 * h, h)
    return 4 * (_mm(y, h, half) + 4 * per_wn + _mm(y, half, h))


def flow_weight_bytes(cfg: Dict) -> int:
    h, half = cfg["hidden_channels"], cfg["inter_channels"] // 2
    per = (h * half + h + 4 * (2 * h * h * 5 + 2 * h) + 3 * (2 * h * h + 2 * h)
           + (h * h + h) + half * h + half)
    return 4 * per * F32


def flow_bytes(cfg: Dict, frames: int) -> float:
    """Kernel B's activations: the latents in and out."""
    return 2.0 * frames * cfg["inter_channels"] * F32


def prior_expand(cfg: Dict, t_text: int, frames: int) -> float:
    return 2 * _mm(frames, cfg["inter_channels"], t_text)


def stages(cfg: Dict) -> List[Dict]:
    """Each decoder stage's frame multiple, channels and resblock group."""
    out, ch, mult = [], cfg["upsample_initial_channel"], 1
    convs = 2 if cfg["resblock"] == "1" else 1
    for rate, k in zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"]):
        mult *= rate
        out.append({"mult": mult, "in": ch, "ch": ch // 2, "up_kernel": k,
                    "convs": [(rk, convs * len(d)) for rk, d in zip(
                        cfg["resblock_kernel_sizes"],
                        cfg["resblock_dilation_sizes"])]})
        ch //= 2
    return out


def stage_group(cfg: Dict, frames: int) -> float:
    """Kernel C's work: every stage's resblock group and the conv_post
    tail."""
    fl, last = 0.0, None
    for st in stages(cfg):
        t, c = frames * st["mult"], st["ch"]
        fl += sum(n * _mm(t, c, c * k) for k, n in st["convs"])
        last = (t, c)
    return fl + _mm(last[0], 1, last[1] * 7)


def stage_group_bytes(cfg: Dict, frames: int) -> float:
    """Kernel C's activations: each stage's input and output, and the
    tail's audio out."""
    nb = 0.0
    for st in stages(cfg):
        nb += 2.0 * frames * st["mult"] * st["ch"] * F32
    return nb + frames * stages(cfg)[-1]["mult"] * F32


def stage_group_weight_bytes(cfg: Dict) -> int:
    nb = 0
    for st in stages(cfg):
        c = st["ch"]
        nb += sum(n * (c * c * k + c) for k, n in st["convs"])
    return (nb + 7 * stages(cfg)[-1]["ch"]) * F32


def decoder(cfg: Dict, frames: int) -> float:
    fl = _mm(frames, cfg["upsample_initial_channel"],
             cfg["inter_channels"] * 7)
    for st, rate in zip(stages(cfg), cfg["upsample_rates"]):
        t_in = frames * st["mult"] // rate
        fl += _mm(t_in, st["ch"], st["in"] * st["up_kernel"])
    return fl + stage_group(cfg, frames)


def infer(cfg: Dict, t_text: int, frames: int) -> float:
    """One request's model FLOPs at its true ids and frames."""
    return (text_encoder(cfg, t_text) + sdp_reverse(cfg, t_text)
            + prior_expand(cfg, t_text, frames) + flow(cfg, frames)
            + decoder(cfg, frames))


def posterior(cfg: Dict, frames: int) -> float:
    """Posterior encoder: pre 1x1, WN(kernel 5, 16 layers), proj."""
    y, h = frames, cfg["hidden_channels"]
    per_wn = _mm(y, 2 * h, h * 5) + _mm(y, 2 * h, h)
    return (_mm(y, h, cfg["spec_channels"]) + 16 * per_wn
            + _mm(y, 2 * cfg["inter_channels"], h))


def sdp_nll(cfg: Dict, t_text: int) -> float:
    """SDP training NLL: main and duration-posterior trunks, 4 posterior
    and 4 prior spline flows."""
    t, h, k = t_text, cfg["hidden_channels"], cfg["kernel_size"]
    trunk = _mm(t, h, h) + _dds(t, h, k, 3) + _mm(t, h, h)
    post_trunk = _mm(t, h, 1) + _dds(t, h, k, 3) + _mm(t, h, h)
    per_cf = _mm(t, h, 1) + _dds(t, h, k, 3) + _mm(t, 29, h)
    return trunk + post_trunk + 8 * per_cf


def mas_scores(cfg: Dict, t_text: int, frames: int) -> float:
    """The alignment's score einsums (the DP itself is comparisons)."""
    return 2 * _mm(frames, t_text, cfg["inter_channels"])


def disc_p(period: int, n_samples: int) -> float:
    """One period discriminator: the waveform folded to [n/p, p], five
    (5, 1) convs (stride 3 but the last) and conv_post (3, 1)."""
    chans = [(1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024)]
    h = -(-n_samples // period)
    fl = 0.0
    for i, (i_ch, o_ch) in enumerate(chans):
        s = 3 if i < len(chans) - 1 else 1
        h_out = -(-h // s)
        fl += _mm(h_out * period, o_ch, i_ch * 5)
        h = h_out
    return fl + _mm(h * period, 1, 1024 * 3)


def disc_s(n_samples: int) -> float:
    """The scale discriminator: grouped strided 1d convs and conv_post."""
    specs = [(1, 16, 15, 1, 1), (16, 64, 41, 4, 4), (64, 256, 41, 4, 16),
             (256, 1024, 41, 4, 64), (1024, 1024, 41, 4, 256),
             (1024, 1024, 5, 1, 1)]
    t, fl = n_samples, 0.0
    for i_ch, o_ch, k, s, groups in specs:
        t_out = -(-t // s)
        fl += _mm(t_out, o_ch, (i_ch // groups) * k)
        t = t_out
    return fl + _mm(t, 1, 1024 * 3)


def train_step(cfg: Dict, t_text: int, frames: int, periods) -> float:
    """One G+D step's model FLOPs for one row at its true lengths: the
    generator's training forward (encoder, SDP NLL, posterior, flow, MAS
    scores, the decoder on the segment) 3x (forward and backward), and
    7 discriminator forwards' worth (D(y), D(y_hat) in the generator loss,
    both again in the discriminator's, an input backward and a weight
    backward)."""
    seg = cfg["segment_size"]
    gen = (text_encoder(cfg, t_text) + sdp_nll(cfg, t_text)
           + posterior(cfg, frames) + flow(cfg, frames)
           + mas_scores(cfg, t_text, frames) + decoder(cfg, seg))
    n = seg * cfg["hop_length"]
    disc = sum(disc_p(p, n) for p in periods) + disc_s(n)
    return 3.0 * gen + 7.0 * disc


def least_seconds(flops: float, nbytes: float, peak_flops: float,
                  peak_bytes: float) -> float:
    return max(flops / peak_flops, nbytes / peak_bytes)
