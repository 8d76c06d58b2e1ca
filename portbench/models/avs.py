"""AVS: `AVSInferenceEngine.stream_masks` with float32 logits
(`mask_u8=False`: masks rounded to 1/255 would blunt the comparison);
judged on the mask logits."""
from __future__ import annotations

from ..reference.heads import avs_forward, init_avs
from .common import dataclass_from, stream_knobs

OUTPUTS = ("masks",)
init = init_avs
reference = avs_forward


def clip_shapes(cfg):
    """A clip's wire arrays: int16 waves (T, L) and uint8 frames at the
    mask size (T, S, S, 3)."""
    T = cfg.num_frames
    return {"wave": (T, cfg.htsat.frontend.clip_samples),
            "image": (T, cfg.mask_size, cfg.mask_size, 3)}


def engine(model, serve, mix, params, state, device):
    """The port's engine on the benchmark's weights."""
    from dg_sct_tpu_torch.configs import AVSModelConfig
    from dg_sct_tpu_torch.serve import AVSInferenceEngine

    cfg = dataclass_from(AVSModelConfig, model)
    return AVSInferenceEngine(cfg, params, state, mask_u8=False,
                              **stream_knobs(mix, serve, device))


def int8_engine(model, serve, mix, params, state, device, calib):
    """The program's int8 path: the towers in int8 at static scales,
    calibrated on `calib` (a batch's wire arrays) by a float engine (the AVS
    engine quantizes no adapter). The AVS check cannot tell it from bf16
    (PERF.md), so it is a reading, not the control."""
    from dg_sct_tpu_torch.configs import AVSModelConfig
    from dg_sct_tpu_torch.ops import quant
    from dg_sct_tpu_torch.serve import AVSInferenceEngine

    cfg = dataclass_from(AVSModelConfig, model)
    knobs = dict(mask_u8=False, **stream_knobs(mix, serve, device))
    f = AVSInferenceEngine(cfg, params, state, **knobs)
    wave, frames = (f._to_dev(a) for a in calib)
    scales = quant.calibrate_avs(f.params, f.state, f.cfg, f._wave(wave), f._frames(frames),
                                 gelu=f.gelu, device=f.device)
    del f
    return AVSInferenceEngine(cfg, params, state, int8_towers=True, act_scales=scales, **knobs)


def stream(eng, ds):
    """Yield ({"masks": (n, T, H, W)}, pool clips) a block of `stream_masks`."""
    for masks, metas in eng.stream_masks(ds):
        yield {"masks": masks}, [int(video) for _, video in metas]


def request(eng, wave, frames):
    raise NotImplementedError("the AVS engine serves streams only")
