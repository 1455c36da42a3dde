"""Piecewise rational-quadratic spline flows.

PyTorch port of ``phoonnx_tpu/models/vits/transforms.py`` (reference:
phoonnx_train/vits/transforms.py:10-212): the spline is evaluated
everywhere and combined with the identity tails by ``where``, and the
bin lookup is a one-hot contraction. Half-precision inputs are computed
in f32 (bf16 knots collapse bins and produce NaN).
"""

import math
from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _bin_positions(unnormalized: Tensor, num_bins: int, min_size: float,
                   low: float, high: float) -> Tuple[Tensor, Tensor]:
    """Softmax-normalised bin sizes -> (cumulative_knots, bin_sizes)."""
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_size + (1.0 - min_size * num_bins) * sizes
    cum = torch.cumsum(sizes, dim=-1)
    cum = F.pad(cum, (1, 0))
    cum = (high - low) * cum + low
    # pin the endpoints exactly (cumsum rounding would otherwise drift)
    cum = torch.cat([torch.full_like(cum[..., :1], low), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], high)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def _searchsorted(bin_locations: Tensor, inputs: Tensor,
                  eps: float = 1e-6) -> Tensor:
    locations = torch.cat([bin_locations[..., :-1],
                           bin_locations[..., -1:] + eps], dim=-1)
    return torch.sum(inputs[..., None] >= locations, dim=-1) - 1


def rational_quadratic_spline(
    inputs: Tensor,
    unnormalized_widths: Tensor,
    unnormalized_heights: Tensor,
    unnormalized_derivatives: Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[Tensor, Tensor]:
    """Monotone RQS on the box [left,right]x[bottom,top]."""
    orig_dtype = inputs.dtype
    if orig_dtype in (torch.bfloat16, torch.float16):
        inputs = inputs.float()
        unnormalized_widths = unnormalized_widths.float()
        unnormalized_heights = unnormalized_heights.float()
        unnormalized_derivatives = unnormalized_derivatives.float()
    num_bins = unnormalized_widths.shape[-1]

    cumwidths, widths = _bin_positions(
        unnormalized_widths, num_bins, min_bin_width, left, right)
    cumheights, heights = _bin_positions(
        unnormalized_heights, num_bins, min_bin_height, bottom, top)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)
    bin_idx = torch.clamp(bin_idx, 0, num_bins - 1)
    onehot = (bin_idx[..., None] == torch.arange(
        num_bins, device=inputs.device)).to(inputs.dtype)

    def pick(table: Tensor) -> Tensor:
        return torch.sum(table[..., :num_bins] * onehot, dim=-1)

    in_cumwidths = pick(cumwidths)
    in_widths = pick(widths)
    in_cumheights = pick(cumheights)
    in_heights = pick(heights)
    delta = heights / widths
    in_delta = pick(delta)
    in_deriv = pick(derivatives)
    in_deriv_p1 = pick(derivatives[..., 1:])

    if inverse:
        term = inputs - in_cumheights
        a = term * (in_deriv + in_deriv_p1 - 2 * in_delta) + in_heights * (
            in_delta - in_deriv)
        b = in_heights * in_deriv - term * (
            in_deriv + in_deriv_p1 - 2 * in_delta)
        c = -in_delta * term
        discriminant = torch.clamp(b * b - 4 * a * c, min=0.0)
        root = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs = root * in_widths + in_cumwidths

        theta_1m = root * (1 - root)
        denominator = in_delta + (
            (in_deriv + in_deriv_p1 - 2 * in_delta) * theta_1m)
        deriv_numerator = torch.square(in_delta) * (
            in_deriv_p1 * torch.square(root)
            + 2 * in_delta * theta_1m
            + in_deriv * torch.square(1 - root))
        logabsdet = torch.log(deriv_numerator) - 2 * torch.log(denominator)
        return outputs.to(orig_dtype), (-logabsdet).to(orig_dtype)

    theta = (inputs - in_cumwidths) / in_widths
    theta_1m = theta * (1 - theta)
    numerator = in_heights * (
        in_delta * torch.square(theta) + in_deriv * theta_1m)
    denominator = in_delta + (
        (in_deriv + in_deriv_p1 - 2 * in_delta) * theta_1m)
    outputs = in_cumheights + numerator / denominator
    deriv_numerator = torch.square(in_delta) * (
        in_deriv_p1 * torch.square(theta)
        + 2 * in_delta * theta_1m
        + in_deriv * torch.square(1 - theta))
    logabsdet = torch.log(deriv_numerator) - 2 * torch.log(denominator)
    return outputs.to(orig_dtype), logabsdet.to(orig_dtype)


def unconstrained_rational_quadratic_spline(
    inputs: Tensor,
    unnormalized_widths: Tensor,
    unnormalized_heights: Tensor,
    unnormalized_derivatives: Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[Tensor, Tensor]:
    """RQS with identity linear tails outside [-tail_bound, tail_bound];
    boundary derivatives pinned to 1 (reference: transforms.py:68-76)."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.exp(1 - min_derivative) - 1)
    derivs = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    clamped = torch.clamp(inputs, -tail_bound, tail_bound)
    spline_out, spline_ld = rational_quadratic_spline(
        clamped, unnormalized_widths, unnormalized_heights, derivs,
        inverse=inverse, left=-tail_bound, right=tail_bound,
        bottom=-tail_bound, top=tail_bound, min_bin_width=min_bin_width,
        min_bin_height=min_bin_height, min_derivative=min_derivative)
    outputs = torch.where(inside, spline_out, inputs)
    logabsdet = torch.where(inside, spline_ld, torch.zeros_like(spline_ld))
    return outputs, logabsdet


def piecewise_rational_quadratic_transform(
    inputs, unnormalized_widths, unnormalized_heights,
    unnormalized_derivatives, inverse=False, tails=None, tail_bound=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    """Dispatcher matching the reference call surface (transforms.py:10-41)."""
    if tails is None:
        return rational_quadratic_spline(
            inputs, unnormalized_widths, unnormalized_heights,
            unnormalized_derivatives, inverse=inverse,
            min_bin_width=min_bin_width, min_bin_height=min_bin_height,
            min_derivative=min_derivative)
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented.")
    return unconstrained_rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=inverse, tail_bound=tail_bound,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative)
