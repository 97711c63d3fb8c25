"""longreadselfcorrect_tpu — JAX long-read self-correction framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
ccuchengwei/LongReadSelfCorrect (StriDe fork): FM-index backward search as
batched rank kernels, seed probing as vectorised k-mer scans, seed-to-seed
FM-extension as a masked beam frontier, and MSA consensus as fixed-band DP.
"""

__version__ = "0.1.0"
