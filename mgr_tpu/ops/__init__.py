"""Compute ops: CTC, fused BLSTM scan, MFCC, kinematics, decode.

This package is the framework's "native" layer — the counterpart of the
C++ TF kernels the reference delegates to (`K.ctc_batch_cost` at
/root/reference/audio_network/losses.py:13 and the bundled LSTM kernels).
Pure-JAX implementations are the source of truth; the Triton-route
Pallas CTC kernel in `mgr_tpu.ops.pallas_kernels` runs on the GPU.
"""
