"""Model zoo: shapes, determinism, freezing, CNN geometry."""

import jax
import jax.numpy as jnp
import numpy as np

from mgr_tpu.core import config as cfglib
from mgr_tpu.models import build_model, layers


def _tiny(name, **kw):
    cfg = cfglib.get_preset(name)
    enc = cfg.encoder
    small_enc = cfglib.EncoderConfig(
        hidden=8, depth=enc.depth, input_noise=enc.input_noise,
        dropout=enc.dropout, output_dropout=enc.output_dropout,
    )
    over = dict(maxlen=12, batch_size=2, encoder=small_enc,
                compute_dtype="float32")
    over.update(kw)
    return cfg.replace(**over)


def test_speech_shapes_and_modes():
    cfg = _tiny("speech", num_feats=5, nb_classes=7)
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (2, cfg.maxlen, 5))
    out_eval = model.apply(params, x)
    assert out_eval.shape == (2, cfg.maxlen, 7)
    # eval is deterministic
    out_eval2 = model.apply(params, x)
    np.testing.assert_array_equal(np.asarray(out_eval), np.asarray(out_eval2))
    # train mode with noise+dropout differs
    out_tr = model.apply(params, x, train=True, rng=jax.random.key(2))
    assert not np.allclose(np.asarray(out_tr), np.asarray(out_eval))


def test_skeletal_shapes():
    cfg = _tiny("skeletal", num_feats=4, nb_classes=6)
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (2, cfg.maxlen, 4))
    assert model.apply(params, x).shape == (2, cfg.maxlen, 6)


def test_rgb_shapes_and_cnn_geometry():
    cnn = cfglib.CNNConfig(img_dim=20, channels=(4, 6, 8),
                           kernel_sizes=(5, 5, 4), pool_sizes=(2, 2, 2))
    # 20 -conv5-> 16 -pool-> 8 -conv5-> 4 ... too small; use img 28
    cnn = cfglib.CNNConfig(img_dim=28, channels=(4, 6, 8),
                           kernel_sizes=(5, 5, 4), pool_sizes=(2, 2, 2))
    # 28->24->12 ; 12->8->4 ; 4->1->0 invalid. img 36:
    cnn = cfglib.CNNConfig(img_dim=36, channels=(4, 6, 8),
                           kernel_sizes=(5, 5, 4), pool_sizes=(2, 2, 2))
    # 36->32->16 ; 16->12->6 ; 6->3->1 => 1*1*8 = 8
    assert layers.cnn_output_dim(cnn) == 8
    cfg = _tiny("rgb", cnn=cnn, nb_classes=5, maxlen=4)
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (2, 4, 36, 36, 1))
    out = model.apply(params, x)
    assert out.shape == (2, 4, 5)


def test_rgb_trains_in_bfloat16():
    """Regression: the conv frontend's gradient must exist under bf16
    compute. With ``preferred_element_type=f32`` the conv VJP received
    an f32 cotangent against bf16 operands and raised a TypeError, so
    bf16 RGB training (the production compute dtype) was broken; CPU
    tests run f32 and never saw it."""
    cnn = cfglib.CNNConfig(img_dim=36, channels=(4, 6, 8),
                           kernel_sizes=(5, 5, 4), pool_sizes=(2, 2, 2))
    cfg = _tiny("rgb", cnn=cnn, nb_classes=5, maxlen=4,
                compute_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (2, 4, 36, 36, 1))

    from mgr_tpu.ops.ctc import ctc_loss_from_logits

    def loss_fn(p):
        logits = model.apply(p, x, train=True, rng=jax.random.key(2))
        labels = jnp.array([[1, 2, -1], [3, -1, -1]], jnp.int32)
        return ctc_loss_from_logits(
            logits.astype(jnp.float32), labels,
            jnp.array([4, 4], jnp.int32), jnp.array([2, 1], jnp.int32),
        ).mean()

    loss, grads = jax.value_and_grad(loss_fn)(params)
    assert np.isfinite(float(loss))
    g = np.asarray(grads["cnn"]["conv_0"], np.float32)
    assert np.isfinite(g).all() and np.abs(g).sum() > 0


def test_reference_cnn_geometry():
    # The reference geometry: 60 -> conv5 56 -> pool 28 -> conv5 24 ->
    # pool 12 -> conv4 9 -> pool 4 => 4*4*48 = 768 flat features.
    cnn = cfglib.CNNConfig()
    assert layers.cnn_output_dim(cnn) == 4 * 4 * 48


def test_early_fusion_two_streams():
    cfg = _tiny("early_fusion", num_feats=5, second_stream_feats=3,
                nb_classes=6)
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    xa = jax.random.normal(jax.random.key(1), (2, cfg.maxlen, 5))
    xs = jax.random.normal(jax.random.key(2), (2, cfg.maxlen, 3))
    out = model.apply(params, (xa, xs))
    assert out.shape == (2, cfg.maxlen, 6)


def test_late_fusion_shapes_and_freeze_mask():
    sp = _tiny("speech", num_feats=5)
    sk = _tiny("skeletal", num_feats=4)
    cfg = _tiny("late_fusion", num_feats=5, second_stream_feats=4,
                nb_classes=6, fusion_hidden=4)
    model = build_model(cfg, source_configs={"speech": sp, "skeletal": sk})
    params = model.init(jax.random.key(0))
    xa = jax.random.normal(jax.random.key(1), (2, cfg.maxlen, 5))
    xs = jax.random.normal(jax.random.key(2), (2, cfg.maxlen, 4))
    out = model.apply(params, (xa, xs))
    assert out.shape == (2, cfg.maxlen, 6)

    mask = model.trainable(params)
    froz = jax.tree.leaves(mask["speech"]) + jax.tree.leaves(mask["skeletal"])
    live = jax.tree.leaves(mask["fusion"]) + jax.tree.leaves(mask["head"])
    assert all(v is False for v in froz)
    assert all(v is True for v in live)

    # Encoder param shapes line up with the uni-modal models so that
    # pretrained checkpoints graft directly.
    sp_params = build_model(sp).init(jax.random.key(3))
    assert jax.tree.map(jnp.shape, params["speech"]) == jax.tree.map(
        jnp.shape, sp_params["encoder"]
    )


def test_late_fusion_finetune_unfreezes_encoders():
    """finetune_encoders=True flips the encoder freeze mask (framework
    extension; the reference always freezes, multimodal.py:33-55) and a
    train step then actually moves encoder params."""
    sp = _tiny("speech", num_feats=5)
    sk = _tiny("skeletal", num_feats=4)
    cfg = _tiny("late_fusion", num_feats=5, second_stream_feats=4,
                nb_classes=6, fusion_hidden=4, finetune_encoders=True)
    model = build_model(cfg, source_configs={"speech": sp, "skeletal": sk})
    params = model.init(jax.random.key(0))
    mask = model.trainable(params)
    assert all(v is True for v in jax.tree.leaves(mask))

    from mgr_tpu.train.step import create_train_state, make_train_step

    state = create_train_state(model, jax.random.key(1))
    step = make_train_step(model)
    batch = {
        "inputs": jax.random.normal(jax.random.key(2), (2, cfg.maxlen, 5)),
        "inputs2": jax.random.normal(jax.random.key(3), (2, cfg.maxlen, 4)),
        "labels": jnp.array([[1, 2], [3, 4]], dtype=jnp.int32),
        "input_length": jnp.full((2,), cfg.maxlen, jnp.int32),
        "label_length": jnp.full((2,), 2, jnp.int32),
    }
    before = jax.tree.map(jnp.copy, state.params["speech"])
    state2, _ = step(state, batch, jax.random.key(4), 1.0)
    moved = jax.tree.map(
        lambda a, b: bool(jnp.any(a != b)), before, state2.params["speech"]
    )
    assert any(jax.tree.leaves(moved)), "encoder params did not move"


def test_jit_apply():
    cfg = _tiny("speech", num_feats=5, nb_classes=7)
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (2, cfg.maxlen, 5))
    jit_apply = jax.jit(lambda p, x: model.apply(p, x))
    out = jit_apply(params, x)
    assert np.all(np.isfinite(np.asarray(out)))


def test_apply_matches_apply_tm_all_families():
    """The public batch-major apply is exactly the transpose of the
    time-major path for every family."""
    import jax.numpy as jnp

    sp = _tiny("speech", num_feats=5, nb_classes=7)
    sk = _tiny("skeletal", num_feats=4, nb_classes=7)
    cases = []

    m = build_model(sp)
    x = jax.random.normal(jax.random.key(1), (2, sp.maxlen, 5))
    cases.append((m, x))

    m = build_model(sk)
    xs = jax.random.normal(jax.random.key(2), (2, sk.maxlen, 4))
    cases.append((m, xs))

    cnn = cfglib.CNNConfig(img_dim=36, channels=(2, 3, 4),
                           kernel_sizes=(5, 5, 4), pool_sizes=(2, 2, 2))
    rgb = _tiny("rgb", cnn=cnn, nb_classes=5, maxlen=4)
    m = build_model(rgb)
    xv = jax.random.normal(jax.random.key(3), (2, 4, 36, 36, 1))
    cases.append((m, xv))

    ef = _tiny("early_fusion", num_feats=5, second_stream_feats=3,
               nb_classes=7)
    m = build_model(ef)
    cases.append((m, (x, jax.random.normal(jax.random.key(4),
                                           (2, ef.maxlen, 3)))))

    lf = _tiny("late_fusion", num_feats=5, second_stream_feats=4,
               nb_classes=7, fusion_hidden=4, encoder=sp.encoder)
    m = build_model(lf, source_configs={"speech": sp, "skeletal": sk})
    cases.append((m, (x, xs)))

    for model, inputs in cases:
        params = model.init(jax.random.key(0))
        out = model.apply(params, inputs)
        out_tm = model.apply_tm(params, inputs)
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(jnp.swapaxes(out_tm, 0, 1)),
            atol=1e-6, err_msg=model.config.name,
        )


def test_head_blank_bias_init():
    """head_blank_bias seeds only the blank logit's bias (opt-in CTC
    blank-dominance mitigation); default 0.0 keeps keras-parity zeros."""
    cfg = _tiny("speech", num_feats=5, nb_classes=7)
    b0 = build_model(cfg).init(jax.random.key(0))["head"]["b"]
    assert float(np.abs(np.asarray(b0)).max()) == 0.0
    cfg2 = cfg.replace(head_blank_bias=-3.0)
    b = np.asarray(build_model(cfg2).init(jax.random.key(0))["head"]["b"])
    assert b[-1] == -3.0 and np.all(b[:-1] == 0.0)
