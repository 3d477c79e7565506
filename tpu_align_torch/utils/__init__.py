"""Utilities: synthetic workloads, output reordering, host allocator
tuning, the DP-matrix printer and the phase-breakdown analysis (the port's
copies of tpu_align/utils/synthetic.py, reorder.py, hostmem.py, pretty.py
and timing_analysis.py)."""

from tpu_align_torch.utils.reorder import reorder_output
from tpu_align_torch.utils.synthetic import mutate, synthetic_dataset

__all__ = ["synthetic_dataset", "mutate", "reorder_output"]
