"""Copy-last-frame baseline with the transformer's call signature
(``sd_video_gen_tpu/models/identity.py``): the naive-prediction control."""

from __future__ import annotations

from torch import nn


class IdentityModel(nn.Module):
    def forward(self, src, tgt, tgt_mask=None, text_embeds=None):
        """Next frame == last input frame, broadcast over tgt's length."""
        return src[:, -1:, :].expand(-1, tgt.shape[1], -1).float()
