"""InceptionI3d (Kinetics-400) for FVD evaluation
(``sd_video_gen_tpu/models/i3d.py``), NCDHW.

The Inception-v1 I3D graph of the reference's ``evaluation/pytorch_i3d.py``:
Conv3d_1a .. Mixed_5c -> average pool (2, 7, 7) -> 1x1x1 logits with bias ->
squeeze -> mean over time. Submodules carry that file's names, so its state
dict (``Conv3d_1a_7x7.conv3d.weight``, ``Mixed_3b.b1b.bn.running_var``,
``logits.conv3d.bias``, ...) loads with ``strict=True`` and no renaming:
``convert_i3d`` is that load.

Padding is XLA's / TF's 'SAME': for output ceil(n / s) the total pad is
max((out - 1) s + k - n, 0), the extra element at the end. torch's
``padding='same'`` refuses stride 2 and a max pool's ``padding=`` is
symmetric, so every pad here is an explicit ``F.pad``; max pools pad with
-inf. BatchNorm is frozen (``eval()``, eps 1e-5, the reference module's).

The temporal stack needs 9 frames (stride-2 stem, two stride-2 pools, then
a kernel-2 VALID pool): the JAX graph turns shorter clips into NaN, this one
raises a ``ValueError`` naming the minimum.

The forward runs in full f32: TF32 is switched off for cuDNN and matmul
around it (PyTorch allows TF32 in cuDNN convolutions by default), so FVD on
the card is the f32 number the JAX package gives on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

MIN_FRAMES = 9
MIN_SIZE = 193   # the smallest side that leaves the (2, 7, 7) pool a 7x7 map


@dataclasses.dataclass(frozen=True)
class I3DConfig:
    num_classes: int = 400
    in_channels: int = 3


def _same_pads(sizes, kernel, stride) -> list[int]:
    """``F.pad`` amounts (last dimension first) for 'SAME' over ``sizes``."""
    pads = []
    for n, k, s in zip(reversed(sizes), reversed(kernel), reversed(stride)):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """3-D max pool with 'SAME' padding of -inf (``_max_pool_same``)."""
    x = F.pad(x, _same_pads(x.shape[2:], kernel, stride),
              value=float("-inf"))
    return F.max_pool3d(x, kernel, stride)


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN and matmul inside the block, restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class Unit3D(nn.Module):
    """conv3d ('SAME') + frozen BN + optional ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel=(1, 1, 1), stride=(1, 1, 1), use_bn: bool = True,
                 use_bias: bool = False, relu: bool = True):
        super().__init__()
        self.kernel, self.stride, self.relu = tuple(kernel), tuple(stride), relu
        self.conv3d = nn.Conv3d(in_channels, out_channels, self.kernel,
                                self.stride, bias=use_bias)
        self.bn = nn.BatchNorm3d(out_channels, eps=1e-5) if use_bn else None

    def forward(self, x):
        x = F.pad(x, _same_pads(x.shape[2:], self.kernel, self.stride))
        x = self.conv3d(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class InceptionModule(nn.Module):
    def __init__(self, in_channels: int, out):
        """``out`` = (b0, b1a, b1b, b2a, b2b, b3b) widths."""
        super().__init__()
        self.out_channels = out[0] + out[2] + out[4] + out[5]
        self.b0 = Unit3D(in_channels, out[0])
        self.b1a = Unit3D(in_channels, out[1])
        self.b1b = Unit3D(out[1], out[2], (3, 3, 3))
        self.b2a = Unit3D(in_channels, out[3])
        self.b2b = Unit3D(out[3], out[4], (3, 3, 3))
        self.b3b = Unit3D(in_channels, out[5])

    def forward(self, x):
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), b3], dim=1)


# (name, out widths) of the Mixed blocks in graph order; a max pool follows
# the names in _POOL_AFTER.
MIXED = [
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
]
_POOL_AFTER = {"Mixed_3c": ((3, 3, 3), (2, 2, 2)),
               "Mixed_4f": ((2, 2, 2), (2, 2, 2))}


def _check_input(x: torch.Tensor) -> None:
    if x.ndim != 5:
        raise ValueError(f"I3D takes (B, C, T, H, W), got {tuple(x.shape)}")
    T, H, W = x.shape[2:]
    if T < MIN_FRAMES:
        raise ValueError(
            f"I3D needs at least {MIN_FRAMES} frames (stride-2 stem, two "
            f"stride-2 pools, then a kernel-2 VALID pool); got {T}: tile "
            "shorter clips to 9 frames")
    if min(H, W) < MIN_SIZE:
        raise ValueError(f"I3D needs frames of at least {MIN_SIZE} px for "
                         f"its final (2, 7, 7) pool; got {H}x{W}")


class InceptionI3d(nn.Module):
    """(B, 3, T, 224, 224) f32 in [-1, 1] -> logits (B, num_classes), or the
    pooled features (B, 1024, T', H', W') with ``return_features``."""

    def __init__(self, cfg: I3DConfig = I3DConfig()):
        super().__init__()
        self.cfg = cfg
        self.Conv3d_1a_7x7 = Unit3D(cfg.in_channels, 64, (7, 7, 7),
                                    (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        c = 192
        for name, out in MIXED:
            block = InceptionModule(c, out)
            self.add_module(name, block)
            c = block.out_channels
        self.logits = Unit3D(c, cfg.num_classes, use_bn=False, use_bias=True,
                             relu=False)

    def forward(self, x, return_features: bool = False):
        _check_input(x)
        with full_f32():
            x = self.Conv3d_1a_7x7(x)
            x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
            x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
            x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
            for name, _ in MIXED:
                x = getattr(self, name)(x)
                if name in _POOL_AFTER:
                    x = max_pool_same(x, *_POOL_AFTER[name])
            feats = F.avg_pool3d(x, (2, 7, 7), stride=1)
            if return_features:
                return feats
            logits = self.logits(feats)              # (B, classes, T', 1, 1)
            return logits.squeeze(4).squeeze(3).mean(dim=2)


def convert_i3d(model: InceptionI3d, sd: dict) -> InceptionI3d:
    """Load a ``pytorch_i3d``-layout state dict into ``model``, strictly: a
    key the model lacks or a parameter the dict lacks raises. A dict saved
    before BatchNorm tracked its batch count (no ``num_batches_tracked``)
    loads as well."""
    model.load_state_dict(sd, strict=True)
    return model
