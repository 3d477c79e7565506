"""tpu-align-torch: the PyTorch + CUDA port of tpu-align for NVIDIA Hopper.

A second package beside the JAX one (`tpu_align`), which stays the
reference.  The port runs the four aligners LNW, LSW, ANW and BSW --
parse, bucketize, the stagger fill (LNW, LSW, ANW) or the banded fill
(BSW) with packed directions, then either the threaded native host walk
or the device walk with event compaction, and the native replay and block
formatter -- with the fills, the walk, the compaction, the row-sweep fill
and Hirschberg's split reduction as hand-written sm_90a CUDA kernels
(csrc/stagger_fill.cu, banded_fill.cu, stagger_walk.cu, rowscan_fill.cu,
split_reduce.cu; the s16x2 experiment in s16x2_core.cu, the DPX op layer
in dpx.cuh).  On CPU tensors every kernel wrapper runs its plain PyTorch
version instead.  A `pairs` mesh (distributed/) runs each bucket's shards
on several devices, and multi-process runs split a dataset by pair id.

The package imports `torch` and nothing of `jax` or of the JAX package:
it keeps its own copies of the host layers it needs, each under the
relative path of its original, so a reader finds the counterpart:

  core/        Algorithm, AlignmentParams, direction codes, results
  io/          pair-file parsing, length bucketing, FASTA ingestion
  native/      its own ctypes binding to native/tpualign.cpp, built by g++
               into build/ at first use
  oracle/      the NumPy reference aligners (one path or every co-optimal
               path; the cross-pair batched fill; the LCS)
  verify/      golden generation, output re-scoring, independent scores
               (scipy's Bellman-Ford, exhaustive enumeration)
  utils/       synthetic workloads, host allocator tuning, block order,
               the DP-matrix printer, the phase-breakdown analysis
  ops/         the DPX op layer: plain versions of the 36 intrinsics, and
               csrc/dpx.cuh mapping each onto its sm_90 instruction
  kernels/     the stagger, banded and row-sweep fill wrappers, their
               plain versions, the build of every CUDA kernel
  traceback/   the host walk over every dirs layout (native, or NumPy on
               request); the device walk's move semantics (decide_step),
               plain walk and compaction, its events and moves modes, the
               native and Python replays; the kernel wrappers; Hirschberg
  runtime/     batch engine (all-paths on the host; warmup; a mesh),
               phase profiler and the kernels' launch counts
  distributed/ data parallelism over a `pairs` mesh of devices (each
               shard's kernels on its own device, joined on the host;
               run stats all-reduced) and multi-process runs over a gloo
               group (host_shard, renumber, merge_output_files)
  scripts/     hw_parity: the engine's full text against the oracle over
               a mixed-length set; fuzz_engine, fuzz_sweep: fixed seed
               ranges through the engine and through every kernel;
               exp_s16x2: the packed s16x2 against the int32 DP core step
  convert.py   Bucket <-> tensors, fill tensors -> BucketFill
  cli.py       the `tpu-align-torch` command

Its Algorithm and AlignmentParams are its own classes, with the JAX
package's values.
"""

from tpu_align_torch.core.params import Algorithm, AlignmentParams

__version__ = "0.1.0"

__all__ = ["Algorithm", "AlignmentParams", "__version__"]
