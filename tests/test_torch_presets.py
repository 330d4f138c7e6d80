"""The port's presets (`livevisionkit_tpu_torch/presets.py`) against the
JAX package's, field for field, and mesh mode selected through them."""

import dataclasses

import pytest
import torch

import livevisionkit_tpu_torch as lt
from livevisionkit_tpu import presets as jpresets
from livevisionkit_tpu_torch import presets as tpresets

MODELS = ["homography", "h", "field", "vector_field", "mesh"]
QA = ["strict", "default", "relaxed"]


@pytest.mark.parametrize("qa", QA)
@pytest.mark.parametrize("model", MODELS)
def test_stabilization_preset_matches_jax(model, qa):
    """Every (model, qa) pair, with non-default smoothing, crop and
    crop_output, equal field for field."""
    kw = dict(smoothing=7, crop=0.08, crop_output=True)
    want = dataclasses.asdict(jpresets.stabilization_preset(model, qa, **kw))
    assert dataclasses.asdict(tpresets.stabilization_preset(model, qa, **kw)) == want
    assert dataclasses.asdict(tpresets.stabilization_preset(model, qa)) == dataclasses.asdict(
        jpresets.stabilization_preset(model, qa))


@pytest.mark.parametrize("mesh", [(16, 16), (9, 11)])
def test_tracker_presets_match_jax(mesh):
    assert dataclasses.asdict(tpresets.homography_preset()) == dataclasses.asdict(
        jpresets.homography_preset())
    assert dataclasses.asdict(tpresets.vector_field_preset(mesh)) == dataclasses.asdict(
        jpresets.vector_field_preset(mesh))
    assert tpresets._QA == jpresets._QA


@pytest.mark.parametrize("bad", [dict(model="affine"), dict(qa="lenient")])
def test_unknown_preset_names_raise(bad):
    with pytest.raises(ValueError, match="unknown"):
        tpresets.stabilization_preset(**bad)
    with pytest.raises(ValueError, match="unknown"):
        jpresets.stabilization_preset(**bad)


def test_field_preset_selects_mesh_mode():
    """`stabilization_preset(model="field")` builds a 16x16 mesh stabilizer
    whose state and first output carry a (2, 16, 16) correction."""
    filt = lt.StabilizationFilter(settings=tpresets.stabilization_preset(model="field"))
    spec = lt.FrameSpec(64, 96, 3, lt.PixelFormat.YUV)
    state = filt.init(spec, device="cpu")
    assert state.tracker.prev_mesh.shape == state.correction.offsets.shape == (2, 16, 16)
    state, out = filt.step(state, lt.Frame.create(torch.rand(3, 64, 96), fmt=lt.PixelFormat.YUV))
    assert state.correction.offsets.shape == (2, 16, 16) and not bool(out.valid)
