"""The three-stage training curriculum: speech -> skeletal -> late fusion.

Encodes the reference's end-to-end recipe (README.md:32-53, call stack
SURVEY.md §3.3): train both uni-modal encoders, then build the fusion
model with the pretrained encoder weights grafted in and frozen
(multimodal.py:58-148). The "100 hours on a GTX 1060" headline covers
this whole schedule; here each stage is a fit() over cached arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from mgr_tpu.core import prng
from mgr_tpu.core.config import PipelineConfig, get_preset
from mgr_tpu.data.batcher import Batcher
from mgr_tpu.models import build_model
from mgr_tpu.models.zoo import ModelDef
from mgr_tpu.train.loop import FitResult, fit, load_params_for_eval

Params = Dict[str, Any]


def graft_pretrained_encoders(
    fusion_params: Params,
    speech_params: Params,
    skeletal_params: Params,
) -> Params:
    """Insert pretrained uni-modal encoder weights into a freshly
    initialized late-fusion parameter tree (the functional equivalent of
    reusing the pretrained Keras layer objects, multimodal.py:109-118).

    The encoders' subtree structure is identical to the uni-modal
    models' ``params['encoder']`` (verified by test_models.py), so this
    is a pure dict replacement."""
    out = dict(fusion_params)
    out["speech"] = speech_params["encoder"]
    out["skeletal"] = skeletal_params["encoder"]
    return out


def build_fusion_with_pretrained(
    workdir: str,
    fusion_cfg: Optional[PipelineConfig] = None,
    source_configs: Optional[Dict[str, PipelineConfig]] = None,
    *,
    slot: str = "best",
) -> tuple[ModelDef, Params]:
    """Load the best speech/skeletal checkpoints from ``workdir`` and
    return (fusion ModelDef, grafted init params)."""
    fusion_cfg = fusion_cfg or get_preset("late_fusion")
    sources = source_configs or {
        "speech": get_preset("speech"), "skeletal": get_preset("skeletal")
    }
    speech_params = load_params_for_eval(
        build_model(sources["speech"]), workdir, slot=slot
    )
    skeletal_params = load_params_for_eval(
        build_model(sources["skeletal"]), workdir, slot=slot
    )
    model = build_model(fusion_cfg, source_configs=sources)
    init = model.init(prng.root_key(fusion_cfg.seed))
    params = graft_pretrained_encoders(init, speech_params, skeletal_params)
    return model, params


def run_curriculum(
    speech_data: Batcher,
    skeletal_data: Batcher,
    fusion_data: Batcher,
    workdir: str,
    *,
    configs: Optional[Dict[str, PipelineConfig]] = None,
    mesh=None,
    epochs: Optional[int] = None,
) -> Dict[str, FitResult]:
    """Full three-stage schedule. ``epochs`` overrides every stage's
    epoch budget (useful for smoke tests)."""
    cfgs = configs or {
        "speech": get_preset("speech"),
        "skeletal": get_preset("skeletal"),
        "late_fusion": get_preset("late_fusion"),
    }
    results: Dict[str, FitResult] = {}

    for stage, data in (("speech", speech_data), ("skeletal", skeletal_data)):
        model = build_model(cfgs[stage])
        results[stage] = fit(
            model, data, workdir=workdir, mesh=mesh, epochs=epochs
        )

    fusion_model, grafted = build_fusion_with_pretrained(
        workdir, cfgs["late_fusion"],
        {"speech": cfgs["speech"], "skeletal": cfgs["skeletal"]},
    )
    # Start fusion training from the grafted params: fit() resumes from
    # a pre-seeded "latest" checkpoint carrying them.
    from mgr_tpu.core import checkpoint as ckpt_lib
    from mgr_tpu.train.step import create_train_state

    state = create_train_state(fusion_model, prng.root_key(
        cfgs["late_fusion"].seed
    ))
    state = state._replace(params=grafted)
    ckpt_lib.save_checkpoint(
        workdir, cfgs["late_fusion"].name, state, slot="latest"
    )
    results["late_fusion"] = fit(
        fusion_model, fusion_data, workdir=workdir, mesh=mesh,
        resume=True, epochs=epochs,
    )
    return results
