"""PreconditionerSparseUNet: a U-Net over sparse matrix patterns.

Counterpart of ``deeppreconditioning_tpu/models/sparse_unet.py``:
submanifold 3x3 encoders, stride-2 3x3 downsamplers, inverse convs that
restore a downsampler's input site set, skip additions, and the
output transform of ``PreconditionerNet``.  ``UNetPlanBuilder`` builds
the 17 layer plans on the host.  An inverse conv restores exactly the
site set (and order) of the matching downsampler's input, so every skip
adds two arrays of one layout.

Each layer runs, in this order: the conv, LeakyReLU 0.01 (every layer but
``out``), the skip add (``UNET_SKIPS``), and the saving of an ``enc*``
layer's output.  As in the JAX package, the output conv emits one
channel (the reference's emits ``channels[5]``, of which only channel 0
is read).  Parameters: ``w_{name}`` (K, Cin, Cout), ``b_{name}`` (Cout,),
as the checkpoints store them; ``models.precond_net.init_params`` draws
them fresh, as for ``PreconditionerNet``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from deeppreconditioning_tpu_torch.models.precond_net import (
    conv_param,
    output_transform,
)
from deeppreconditioning_tpu_torch.ops.sparse_conv import (
    ConvSpec,
    LayerPlan,
    SamplePlanHost,
    apply_sparse_conv,
    build_conv_maps,
    build_inverse_conv_maps,
)

_SUBM3 = ConvSpec((3, 3), (1, 1), stride=1, submanifold=True)
_DOWN = ConvSpec((3, 3), (1, 1), stride=2, submanifold=False)

# (name, kind, in_level, out_level); kinds: subm3, down, up, subm1
UNET_TOPOLOGY = (
    ("enc1", "subm3", 0, 0),
    ("down1", "down", 0, 1),
    ("enc2", "subm3", 1, 1),
    ("down2", "down", 1, 2),
    ("enc3", "subm3", 2, 2),
    ("down3", "down", 2, 3),
    ("enc4", "subm3", 3, 3),
    ("bneck", "down", 3, 4),
    ("up3", "up", 4, 3),
    ("dec3", "subm3", 3, 3),
    ("up2", "up", 3, 2),
    ("dec2", "subm3", 2, 2),
    ("up1", "up", 2, 1),
    ("dec1", "subm3", 1, 1),
    ("up0", "up", 1, 0),
    ("dec0", "subm3", 0, 0),
    ("out", "subm1", 0, 0),
)

# upsampler -> the encoder whose saved output is added to its output
UNET_SKIPS = {"up3": "enc4", "up2": "enc3", "up1": "enc2", "up0": "enc1"}


class UNetPlanBuilder:
    """Host index plans of the U-Net topology (the dataset's plan-builder
    protocol, ``build``): 17 layers in ``UNET_TOPOLOGY`` order over site
    levels 0..4 (level k: the input set downsampled k times)."""

    def build(self, rows: np.ndarray, cols: np.ndarray,
              hw: Tuple[int, int]) -> SamplePlanHost:
        plan = SamplePlanHost(shapes=[hw])
        level_sites = [(rows.astype(np.int32), cols.astype(np.int32))]
        level_hw = [hw]
        for _ in range(4):
            r, c = level_sites[-1]
            o_rows, o_cols, _, hw_out = build_conv_maps(
                r, c, level_hw[-1], _DOWN
            )
            level_sites.append((o_rows, o_cols))
            level_hw.append(hw_out)
        plan.level_nnz = [s[0].shape[0] for s in level_sites]

        for _, kind, in_lv, out_lv in UNET_TOPOLOGY:
            in_r, in_c = level_sites[in_lv]
            out_r, out_c = level_sites[out_lv]
            if kind == "subm3":
                _, _, gather, _ = build_conv_maps(
                    in_r, in_c, level_hw[in_lv], _SUBM3
                )
            elif kind == "subm1":
                gather = np.arange(in_r.shape[0], dtype=np.int32)[None, :]
            elif kind == "down":
                # the level sites were built by this same call
                _, _, gather, _ = build_conv_maps(
                    in_r, in_c, level_hw[in_lv], _DOWN
                )
            else:
                gather = build_inverse_conv_maps(
                    in_r, in_c, level_hw[in_lv], out_r, out_c, _DOWN
                )
            plan.layer_rows.append(out_r)
            plan.layer_cols.append(out_c)
            plan.layer_gather.append(gather)
            plan.shapes.append(level_hw[out_lv])
            plan.in_level.append(in_lv)
            plan.out_level.append(out_lv)
        return plan


def unet_io(c: Sequence[int]) -> dict:
    """Per-layer (Cin, Cout) from ``channels[0..5]``."""
    return {
        "enc1": (c[0], c[1]), "down1": (c[1], c[2]),
        "enc2": (c[2], c[2]), "down2": (c[2], c[3]),
        "enc3": (c[3], c[3]), "down3": (c[3], c[4]),
        "enc4": (c[4], c[4]), "bneck": (c[4], c[5]),
        "up3": (c[5], c[4]), "dec3": (c[4], c[4]),
        "up2": (c[4], c[3]), "dec2": (c[3], c[3]),
        "up1": (c[3], c[2]), "dec1": (c[2], c[2]),
        "up0": (c[2], c[1]), "dec0": (c[1], c[1]),
        "out": (c[1], 1),
    }


class PreconditionerSparseUNet(nn.Module):
    """U-Net mapping tril(A) patterns to lower-triangular factors L.

    ``forward(features (B, nnz0_pad, channels[0]), plans)``, 17 batched
    ``LayerPlan``s in ``UNET_TOPOLOGY`` order, returns (B, nnz0_pad)
    values of L at the level-0 sites.
    """

    def __init__(self, channels: Tuple[int, ...] = (1, 16, 32, 64, 32, 16, 1)
                 ) -> None:
        super().__init__()
        self.channels = tuple(channels)
        io = unet_io(self.channels)
        for name, kind, _, _ in UNET_TOPOLOGY:
            w, b = conv_param(1 if kind == "subm1" else 9, *io[name])
            self.register_parameter(f"w_{name}", w)
            self.register_parameter(f"b_{name}", b)

    def forward(self, features: torch.Tensor,
                plans: Sequence[LayerPlan]) -> torch.Tensor:
        if len(plans) != len(UNET_TOPOLOGY):
            raise ValueError(f"{len(plans)} plans for "
                             f"{len(UNET_TOPOLOGY)} layers")
        saved = {}
        x = features
        for li, (name, _, _, _) in enumerate(UNET_TOPOLOGY):
            x = apply_sparse_conv(x, plans[li], getattr(self, f"w_{name}"),
                                  getattr(self, f"b_{name}"))
            if name != "out":
                x = torch.where(x >= 0, x, 0.01 * x)
            if name in UNET_SKIPS:
                x = x + saved[UNET_SKIPS[name]]
            if name.startswith("enc"):
                saved[name] = x
        return output_transform(x, plans[-1])
