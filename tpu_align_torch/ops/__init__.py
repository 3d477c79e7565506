"""The DPX op layer (tpu_align/ops counterpart)."""

from tpu_align_torch.ops import dpx

__all__ = ["dpx"]
