"""The reference against the port's plain path (kernels off) at tiny sizes
on the CPU, float32: same tree, same outputs."""
import numpy as np
import pytest
import torch

from portbench.models import ave as kind_ave
from portbench.models import avs as kind_avs
from portbench.models.common import dataclass_from
from portbench.reference import config as ref_config
from portbench.reference.params import Init, seeded

from .tiny import TINY_AVE, TINY_AVS


def _shapes(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _shapes(v, f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _shapes(v, f"{pre}/{i}")
    else:
        yield pre, tuple(tree.shape)


def _inputs(T, L, S, seed=0):
    rng = np.random.default_rng(seed)
    wave = (rng.standard_normal((2, T, L)) * 3276).astype(np.int16)
    frames = rng.integers(0, 256, (2, T, S, S, 3), dtype=np.uint8)
    return torch.as_tensor(wave), torch.as_tensor(frames)


@pytest.mark.parametrize("name", ["ave", "avs"])
def test_trees_match(name):
    from dg_sct_tpu_torch.configs import AVEModelConfig, AVSModelConfig
    from dg_sct_tpu_torch.models import ave, avs

    model, kind = (TINY_AVE, kind_ave) if name == "ave" else (TINY_AVS, kind_avs)
    cls, init = (AVEModelConfig, ave.init_ave_model) if name == "ave" else (
        AVSModelConfig, avs.init_avs_model)
    port = dict(_shapes(init(dataclass_from(cls, model), seed=0, device="meta")))
    ref = dict(_shapes(kind.init(Init(), ref_config.load(model, "exact"))))
    assert port == ref


def test_ave_matches_plain_path():
    from dg_sct_tpu_torch.configs import AVEModelConfig
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.ops.basic import normalize_frames_u8

    cfg = ref_config.load(TINY_AVE, "exact")
    params, state = seeded(lambda i: kind_ave.init(i, cfg), 2 ** 31 + 5, "cpu")
    wave, frames = _inputs(2, 3200, 64)
    with torch.no_grad():
        ref = kind_ave.reference(params, state, wave, frames, cfg)
        got = ave.forward(params, state, wave.float() / 32767.0,
                          normalize_frames_u8(frames, torch.float32),
                          dataclass_from(AVEModelConfig, TINY_AVE), kernels=False, device="cpu")
    for k in kind_ave.OUTPUTS:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5)


def test_avs_matches_plain_path():
    from dg_sct_tpu_torch.configs import AVSModelConfig
    from dg_sct_tpu_torch.models import avs
    from dg_sct_tpu_torch.ops.basic import normalize_frames_u8

    cfg = ref_config.load(TINY_AVS, "exact")
    params, state = seeded(lambda i: kind_avs.init(i, cfg), 2 ** 31 + 6, "cpu")
    wave, frames = _inputs(2, 3200, 64, seed=1)
    with torch.no_grad():
        ref = kind_avs.reference(params, state, wave, frames, cfg)["masks"]
        got = avs.forward(params, state, normalize_frames_u8(frames, torch.float32),
                          wave.float() / 32767.0, dataclass_from(AVSModelConfig, TINY_AVS),
                          kernels=False, device="cpu")["pred"][..., 0].reshape(ref.shape)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_seeded_weights_repeat_and_differ():
    cfg = ref_config.load(TINY_AVE, "exact")
    build = lambda i: kind_ave.init(i, cfg)
    a = seeded(build, 2 ** 31 + 1, "cpu")[0]["swin"]["patch_embed"]["kernel"]
    b = seeded(build, 2 ** 31 + 1, "cpu")[0]["swin"]["patch_embed"]["kernel"]
    c = seeded(build, 2 ** 31 + 2, "cpu")[0]["swin"]["patch_embed"]["kernel"]
    assert a.dtype == torch.float32 and torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, a.bfloat16().float())  # drawn in the serving type
