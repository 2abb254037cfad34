"""PreconditionerNet: a sparse CNN mapping tril(A) to a tril factor L.

Counterpart of ``deeppreconditioning_tpu/models/precond_net.py``: a 1x1
conv in, kernel-2 convs with asymmetric padding (rows (1, 0) for the first
half, cols (0, 1) for the second, which restores the shape), a 1x1 conv
out, PReLU after every layer but the last, then the output transform:
zero at sites with row < col, softplus on the diagonal, so L has a
positive diagonal and M = L L^T is SPD.

The network runs over the index plans of ``ops/sparse_conv``: features
are a dense (B, nnz_pad, C) tensor and every layer is one gather-GEMM.
Parameters carry the checkpoints' names and layouts: ``w{li}`` (K, Cin,
Cout), ``b{li}`` (Cout,), ``prelu{li}`` (1,).  They are loaded from a
checkpoint (``models.conv_model_from_checkpoint``) or drawn by
``init_params`` (torch's Conv2d default, as the reference's init); the
module's own values are placeholders (zero weights, the 0.25 PReLU
slope).  Softplus is
``logaddexp(x, 0)``, as ``jax.nn.softplus``: torch's ``softplus`` returns x
unchanged above its threshold.  The forward takes a batch, so the
reference's vmapped ``batched_apply(model, params, features, plans)`` is
``model(features, plans)`` here.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from deeppreconditioning_tpu_torch.metrics import scatter_tril_dense
from deeppreconditioning_tpu_torch.ops.sparse_conv import (
    ConvSpec,
    LayerPlan,
    apply_sparse_conv,
)


def precond_net_specs(channels: Sequence[int]) -> List[ConvSpec]:
    """Layer specs for an odd-length channels list: 1x1 in, kernel-2
    hidden layers padded (1, 0) for the first half and (0, 1) for the
    second, 1x1 out."""
    if not len(channels) % 2:
        raise ValueError("channels list must have odd length")
    specs = [ConvSpec((1, 1), (0, 0))]
    for index in range(len(channels) - 3):
        padding = (1, 0) if index < (len(channels) - 2) // 2 else (0, 1)
        specs.append(ConvSpec((2, 2), padding))
    specs.append(ConvSpec((1, 1), (0, 0)))
    return specs


def conv_param(k: int, cin: int, cout: int) -> Tuple[nn.Parameter, ...]:
    """Placeholder weight (K, Cin, Cout) and bias (Cout,), zero."""
    return (nn.Parameter(torch.zeros(k, cin, cout)),
            nn.Parameter(torch.zeros(cout)))


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """The reference's fresh initialization of a conv model, in place,
    drawn from ``generator``: every weight (K, Cin, Cout) and bias uniform
    in +-1 / sqrt(Cin K) (torch's Conv2d default, the reference's
    ``_torch_conv_init``), every PReLU slope 0.25.  This matches the
    reference's distribution, not its bits: the draws come from torch's
    generator, not from a JAX key."""
    with torch.no_grad():
        for name, param in model.named_parameters():
            if name.startswith("prelu"):
                param.fill_(0.25)
                continue
            w = getattr(model, "w" + name[1:])
            bound = 1.0 / math.sqrt(w.shape[0] * w.shape[1])
            u = torch.rand(param.shape, generator=generator,
                           dtype=torch.float64)
            param.copy_((2.0 * u - 1.0) * bound)


def output_transform(x: torch.Tensor, final: LayerPlan) -> torch.Tensor:
    """(B, nnz, C) -> (B, nnz) values of L: channel 0, zero above the
    diagonal, softplus on it, zero at padded sites."""
    vals = x[..., 0]
    vals = torch.where(final.rows < final.cols, 0.0, vals)
    vals = torch.where(final.rows == final.cols,
                       torch.logaddexp(vals, torch.zeros_like(vals)), vals)
    return torch.where(final.valid, vals, 0.0)


class PreconditionerNet(nn.Module):
    """Fully convolutional sparse net returning lower-triangular factors.

    ``forward(features (B, nnz0_pad, channels[0]), plans)``, one batched
    ``LayerPlan`` per layer, returns (B, nnz_out_pad) values of L at the
    final plan's sites.
    """

    def __init__(self, channels: Tuple[int, ...] = (1, 16, 32, 64, 32, 16, 1)
                 ) -> None:
        super().__init__()
        self.channels = tuple(channels)
        self.specs = precond_net_specs(self.channels)
        for li, spec in enumerate(self.specs):
            w, b = conv_param(spec.kernel[0] * spec.kernel[1],
                              self.channels[li], self.channels[li + 1])
            self.register_parameter(f"w{li}", w)
            self.register_parameter(f"b{li}", b)
            if li < len(self.specs) - 1:
                self.register_parameter(
                    f"prelu{li}", nn.Parameter(torch.full((1,), 0.25)))

    def forward(self, features: torch.Tensor,
                plans: Sequence[LayerPlan]) -> torch.Tensor:
        if len(plans) != len(self.specs):
            raise ValueError(f"{len(plans)} plans for {len(self.specs)} "
                             "layers")
        x = features
        for li in range(len(self.specs)):
            x = apply_sparse_conv(x, plans[li], getattr(self, f"w{li}"),
                                  getattr(self, f"b{li}"))
            if li < len(self.specs) - 1:
                x = torch.where(x >= 0, x, getattr(self, f"prelu{li}") * x)
        return output_transform(x, plans[-1])


def output_to_dense(values: torch.Tensor, final_plan: LayerPlan,
                    n: int) -> torch.Tensor:
    """Scatter batched L values to dense (B, n, n) lower-triangular
    matrices."""
    return scatter_tril_dense(values, final_plan.rows, final_plan.cols,
                              final_plan.valid, n)
