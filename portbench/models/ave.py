"""AVE: `AVEInferenceEngine`, streamed by `predict_clips`'s path
(`_StreamingEngine.stream`) or asked by `predict`; judged on the event and
is-event logits."""
from __future__ import annotations

import numpy as np

from ..reference.heads import ave_forward, init_ave
from .common import dataclass_from, stream_knobs

OUTPUTS = ("event_scores", "is_event_scores")
init = init_ave
reference = ave_forward


def clip_shapes(cfg):
    """A clip's wire arrays: int16 waves (T, L) and uint8 frames (T, S, S, 3)."""
    T = cfg.num_frames
    return {"wave": (T, cfg.htsat.frontend.clip_samples),
            "image": (T, cfg.swin.img_size, cfg.swin.img_size, 3)}


def engine(model, serve, mix, params, state, device):
    """The port's engine on the benchmark's weights."""
    from dg_sct_tpu_torch.configs import AVEModelConfig
    from dg_sct_tpu_torch.serve import AVEInferenceEngine

    cfg = dataclass_from(AVEModelConfig, model)
    return AVEInferenceEngine(cfg, params, state, stft_bf16=serve["stft_bf16"],
                              **stream_knobs(mix, serve, device))


def int8_engine(model, serve, mix, params, state, device, calib):
    """The check's control: the engine with the towers, the adapters and the
    Swin-V2 attention core in int8 at static scales, calibrated on `calib`
    (a batch's wire arrays) by a float engine, as the program's int8 serving
    does."""
    from dg_sct_tpu_torch.configs import AVEModelConfig
    from dg_sct_tpu_torch.ops import quant
    from dg_sct_tpu_torch.serve import AVEInferenceEngine

    cfg = dataclass_from(AVEModelConfig, model)
    knobs = dict(stft_bf16=serve["stft_bf16"], **stream_knobs(mix, serve, device))
    f = AVEInferenceEngine(cfg, params, state, **knobs)
    wave, frames = (f._to_dev(a) for a in calib)
    scales = quant.calibrate_ave(f.params, f.state, f.cfg, f._wave(wave), f._frames(frames),
                                 towers=("swin", "htsat", "adapters"), gelu=f.gelu,
                                 device=f.device)
    del f
    return AVEInferenceEngine(cfg, params, state, int8_towers=True, int8_adapters=True,
                              act_scales=scales, int8_attn=True, **knobs)


def stream(eng, ds):
    """Yield ({output: (n, ...)}, pool clips) a block of `eng.stream`."""
    for out, ids in eng.stream(ds):
        rows = [(c, len(r)) for c, r in enumerate(ids) if r]
        yield ({k: np.concatenate([out[k][c, :n] for c, n in rows]) for k in OUTPUTS},
               [int(ds.idx[i]) for r in ids for i in r])


def request(eng, wave, frames):
    out = eng.predict(wave, frames)
    return {k: out[k] for k in OUTPUTS}
