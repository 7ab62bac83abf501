"""Shared layer primitives: dense, Gaussian noise, dropout, CNN frontend.

Initializer parity: every kernel in the reference uses
RandomUniform(-0.05, 0.05) (/root/reference/audio_network/speech_lstm_ctc_words.py:42-44);
biases are zeros.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from mgr_tpu.core.config import CNNConfig

Params = Dict[str, jax.Array]

KERNEL_SCALE = 0.05


def init_dense(rng: jax.Array, in_dim: int, out_dim: int) -> Params:
    W = jax.random.uniform(
        rng, (in_dim, out_dim), minval=-KERNEL_SCALE, maxval=KERNEL_SCALE,
        dtype=jnp.float32,
    )
    return {"W": W, "b": jnp.zeros((out_dim,), jnp.float32)}


def dense(params: Params, x: jax.Array, compute_dtype=jnp.bfloat16) -> jax.Array:
    y = jnp.einsum(
        "...f,fk->...k",
        x.astype(compute_dtype),
        params["W"].astype(compute_dtype),
        preferred_element_type=jnp.float32,
    )
    return y + params["b"]


def gaussian_noise(
    x: jax.Array, stddev: float, rng: Optional[jax.Array], train: bool
) -> jax.Array:
    """Keras GaussianNoise: additive zero-mean noise, train mode only
    (speech_lstm_ctc_words.py:53)."""
    if not train or stddev == 0.0:
        return x
    if rng is None:
        raise ValueError("gaussian_noise requires an rng in train mode")
    return x + stddev * jax.random.normal(rng, x.shape, x.dtype)


def dropout(
    x: jax.Array, rate: float, rng: Optional[jax.Array], train: bool
) -> jax.Array:
    if not train or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("dropout requires an rng in train mode")
    keep = 1.0 - rate
    mask = jax.random.bernoulli(rng, keep, x.shape).astype(x.dtype)
    return x * mask / keep


# ---------------------------------------------------------------------------
# CNN frontend (RGB stream): three TimeDistributed conv/pool blocks
# 16@5x5 / 32@5x5 / 48@4x4, valid padding, relu, 2x2 maxpool
# (/root/reference/rgb_network/cnn_lstm.py:261-298). The time
# axis is folded into the batch so each conv is one big NHWC convolution.
# ---------------------------------------------------------------------------

def init_cnn(rng: jax.Array, cfg: CNNConfig, in_channels: int = 1) -> Params:
    params: Params = {}
    c_in = in_channels
    for i, (c_out, k) in enumerate(zip(cfg.channels, cfg.kernel_sizes)):
        params[f"conv_{i}"] = jax.random.uniform(
            jax.random.fold_in(rng, i), (k, k, c_in, c_out),
            minval=-KERNEL_SCALE, maxval=KERNEL_SCALE, dtype=jnp.float32,
        )
        params[f"bias_{i}"] = jnp.zeros((c_out,), jnp.float32)
        c_in = c_out
    return params


def cnn_output_dim(cfg: CNNConfig) -> int:
    """Flattened feature size after the conv stack on a cfg.img_dim frame."""
    d = cfg.img_dim
    for k, p in zip(cfg.kernel_sizes, cfg.pool_sizes):
        d = (d - k + 1) // p
    return d * d * cfg.channels[-1]


def _max_pool(x: jax.Array, size: int) -> jax.Array:
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        window_dimensions=(1, size, size, 1),
        window_strides=(1, size, size, 1),
        padding="VALID",
    )


def cnn_frontend(
    params: Params, x: jax.Array, cfg: CNNConfig, compute_dtype=jnp.bfloat16
) -> jax.Array:
    """(B, T, H, W, C) video -> (B, T, D) frame features.

    Folds time into batch: one large conv per block instead of T small
    ones (TimeDistributed as one batched op)."""
    B, T, H, W, C = x.shape
    y = x.reshape(B * T, H, W, C).astype(compute_dtype)
    for i, p in enumerate(cfg.pool_sizes):
        kernel = params[f"conv_{i}"].astype(compute_dtype)
        # No preferred_element_type: the conv transpose rule rejects an
        # f32 cotangent against bf16 operands (so bf16 training would
        # fail); the convs accumulate in f32 internally either way, the
        # output dtype only picks the storage rounding.
        y = jax.lax.conv_general_dilated(
            y, kernel,
            window_strides=(1, 1), padding="VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        y = jax.nn.relu(y + params[f"bias_{i}"].astype(compute_dtype))
        y = _max_pool(y, p)
    return y.reshape(B, T, -1).astype(jnp.float32)
