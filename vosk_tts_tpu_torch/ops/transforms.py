"""Piecewise rational-quadratic spline with linear tails
(vosk_tts_tpu/ops/transforms.py; Durkan et al., neural spline flows), in
both directions: the inverse for the SDP reverse pass, the forward with
its log-determinant for the SDP's training NLL.

Branch-free as the JAX version: the spline runs on clamped inputs
everywhere and the tails are selected after."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted(bin_locations, inputs, eps: float = 1e-6):
    bin_locations = bin_locations.detach().clone()
    bin_locations[..., -1] += eps
    return (inputs[..., None] >= bin_locations).sum(dim=-1) - 1


def _edges(unnormalized, lo, hi, min_size):
    """softmax -> min size -> cumulative edges pinned to [lo, hi]."""
    n = unnormalized.shape[-1]
    sizes = min_size + (1 - min_size * n) * torch.softmax(unnormalized, dim=-1)
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (hi - lo) * cum + lo
    cum[..., 0] = lo
    cum[..., -1] = hi
    return cum, cum[..., 1:] - cum[..., :-1]


def _spline(inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
            bound, min_bin_width, min_bin_height, min_derivative, inverse: bool):
    """Rational-quadratic spline on [-bound, bound]^2 -> (outputs,
    logabsdet of the direction taken)."""
    cumwidths, widths = _edges(unnormalized_widths, -bound, bound, min_bin_width)
    cumheights, heights = _edges(unnormalized_heights, -bound, bound, min_bin_height)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    num_bins = widths.shape[-1]
    locations = cumheights if inverse else cumwidths
    bin_idx = _searchsorted(locations, inputs).clamp(0, num_bins - 1)[..., None]

    def gather(t):
        return torch.gather(t, -1, bin_idx)[..., 0]

    input_cumwidths = gather(cumwidths)
    input_bin_widths = gather(widths)
    input_cumheights = gather(cumheights)
    input_delta = gather(heights / widths)
    input_derivatives = gather(derivatives)
    input_derivatives_plus_one = gather(derivatives[..., 1:])
    input_heights = gather(heights)
    d_sum = input_derivatives + input_derivatives_plus_one - 2 * input_delta

    if inverse:
        dy = inputs - input_cumheights
        a = dy * d_sum + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - dy * d_sum
        c = -input_delta * dy
        discriminant = b**2 - 4 * a * c
        theta = (2 * c) / (-b - torch.sqrt(discriminant.clamp(min=0.0)))
        outputs = theta * input_bin_widths + input_cumwidths
    else:
        theta = (inputs - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1 - theta)
    denominator = input_delta + d_sum * theta_one_minus_theta
    derivative_numerator = input_delta**2 * (
        input_derivatives_plus_one * theta**2
        + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta) ** 2
    )
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    if inverse:
        return outputs, -logabsdet
    numerator = input_heights * (input_delta * theta**2 + input_derivatives * theta_one_minus_theta)
    return input_cumheights + numerator / denominator, logabsdet


def piecewise_rational_quadratic_transform(inputs, unnormalized_widths, unnormalized_heights,
                                           unnormalized_derivatives, *, inverse: bool,
                                           tail_bound=1.0,
                                           min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                                           min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                                           min_derivative=DEFAULT_MIN_DERIVATIVE):
    """The spline (``inverse`` or forward), identity (linear tails) outside
    [-tail_bound, tail_bound]. inputs (...,); unnormalized widths/heights
    (..., bins), derivatives (..., bins - 1) -> (outputs, logabsdet)."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.expm1(1 - min_derivative))
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    out, logdet = _spline(inputs.clamp(-tail_bound, tail_bound), unnormalized_widths,
                          unnormalized_heights, unnormalized_derivatives, tail_bound,
                          min_bin_width, min_bin_height, min_derivative, inverse)
    return torch.where(inside, out, inputs), torch.where(inside, logdet, torch.zeros_like(logdet))
