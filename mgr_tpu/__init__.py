"""mgr_tpu — multimodal gesture recognition framework in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
AlexGidiotis/Multimodal-Gesture-Recognition-with-LSTMs-and-CTC
(continuous gesture recognition on ChaLearn 2013 "Montalbano" with
five BLSTM+CTC pipelines: speech, skeletal, RGB video, early fusion,
late multimodal fusion).

Design principles (not a port):
  * All hot compute is batched matmul-shaped: LSTM input
    projections are hoisted out of the recurrence into one large
    (B*T, F) @ (F, 4H) matmul; the serial scan only carries the
    (B, H) @ (H, 4H) recurrent step.
  * CTC loss is a log-space forward recursion under ``lax.scan`` whose
    gradient is taken by XLA autodiff (the backward recursion falls out
    of the chain rule), with a NumPy reference implementation for tests.
  * Data pipelines cache featurized tensors as static-shape arrays and
    shard the batch axis over a ``jax.sharding.Mesh``; there is no
    per-step host CSV parsing (the reference's documented hot loop,
    see /root/reference/audio_network/data_generator.py:153-240).
  * Everything under ``jit`` uses static shapes and lax control flow.

Subpackages:
  core      configs, PRNG threading, checkpointing, metrics, tracing
  ops       CTC, fused BLSTM scan, MFCC, kinematics, image, decoding
  data      dataset contracts, batcher, synthetic data, mixer
  models    the five model families built from shared encoder blocks
  parallel  mesh construction, sharding rules, collectives
  train     optimizers (clip/decay/constraints/freezing), loops, curriculum
  decode    batched best-path decoding, MLF writer, scorers
  cli       non-interactive entry points
"""

__version__ = "0.1.0"

# Keep the top-level import light: subpackages import jax lazily so that
# test processes can set XLA_FLAGS / JAX_PLATFORMS before jax initializes.
from mgr_tpu.core import config  # noqa: F401  (re-export the config module)

__all__ = ["config", "__version__"]
