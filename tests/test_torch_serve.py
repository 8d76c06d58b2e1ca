"""The port's chunked AVE stream (`AVEInferenceEngine.predict_clips` over an
on-disk AVEDataset) against JAX's jitted `ave.forward` on the same stacked
batches, f32 on the CPU, in both wire formats (int16 wave with uint8 RGB
frames; mu-law wave with YUV420 frames), at atol 2e-4 / rtol 2e-3 as
tests/test_torch_ave.py; the ragged padding and its removal; the engine's
GELU and STFT defaults."""
import numpy as np
import jax
import pytest
import torch

from dg_sct_tpu.data import ave as JD
from dg_sct_tpu.models import ave as JA
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu_torch.data import ave as PD
from dg_sct_tpu_torch.models import ave as PA
from dg_sct_tpu_torch.serve import AVEInferenceEngine
from dg_sct_tpu_torch.weights import from_jax
import media_tree
from test_ave_model import tiny_cfg
from torch_port_helpers import port_cfg, scramble_adapters, to_numpy

ATOL, RTOL = 2e-4, 2e-3
N_CLIPS = 7
WIRE = {"u8_i16": {"raw_u8": True}, "yuv420_mulaw": {"yuv420": True, "wave_mulaw": True}}


@pytest.fixture(scope="module", autouse=True)
def flush_denormals():
    """Random test weights drive activations into float32 denormals, which
    the CPU computes ~50x slower; flushing them moves no output beyond 1e-30."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores; a full set of intra-op threads
    in each of them oversubscribes the machine and slows these tiny
    forwards by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """Seeded weights (the port's initialiser; JAX's is slow on the CPU) with
    nonzero adapter gates, as numpy for JAX and carried across by from_jax."""
    jcfg = tiny_cfg()
    pcfg = port_cfg(jcfg)
    jp, js = scramble_adapters(*(to_numpy(t) for t in PA.init_ave_model(pcfg, device="cpu")))
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")  # the parity form, whatever ran before
        fwd = jax.jit(lambda p, s, w, i: JA.forward(p, s, w, i, jcfg, train=False)[0])
        yield jcfg, pcfg, jp, js, pp, ps, fwd


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ave_serve"))
    t = media_tree.make_ave_tree(root, [f"s{i}" for i in range(N_CLIPS)], ["a", "b", "c"],
                                 n_frames=3, img_size=80, wave_samples=2 * 3200,
                                 wave_dtype=np.int16)
    return root, t


def _dataset(mod, tree, cfg, **kw):
    root, t = tree
    return mod.AVEDataset(root, "test", img_size=cfg.swin.img_size, frame_dir=t["frames"],
                          audio_dir=t["audio"], num_frames=cfg.num_frames,
                          segment_samples=cfg.htsat.frontend.clip_samples, **kw)


def _jax_inputs(item):
    """A JAX dataset item -> (float wave, float frames) by the JAX package's
    wire-format ops."""
    w = item["wave"]
    w = (np.asarray(JB.dequantize_mulaw_u8(w)) if w.dtype == np.uint8
         else w.astype(np.float32) / 32767.0)
    if "image_y" in item:
        f = JB.normalize_frames_yuv420(item["image_y"], item["image_uv"], dtype=np.float32)
    else:
        f = JB.normalize_frames_u8(item["image"], dtype=np.float32)
    return w, np.asarray(f)


def _jax_scores(fwd, jp, js, items, B=2):
    """JAX's forward over the clips in batches of B, the last padded with its
    last clip as the engine pads."""
    ins = [_jax_inputs(it) for it in items]
    ev, ie = [], []
    for s in range(0, len(ins), B):
        part = ins[s:s + B]
        k = len(part)
        part = part + [part[-1]] * (B - k)
        out = fwd(jp, js, np.stack([w for w, _ in part]), np.stack([f for _, f in part]))
        ev.append(np.asarray(out["event_scores"])[:k])
        ie.append(np.asarray(out["is_event_scores"])[:k])
    return np.concatenate(ev), np.concatenate(ie)


@pytest.mark.parametrize("wire,chunk", [("u8_i16", 2), ("yuv420_mulaw", 3)])
def test_predict_clips_matches_jax(model, tree, wire, chunk):
    jcfg, pcfg, jp, js, pp, ps, fwd = model
    eng = AVEInferenceEngine(pcfg, pp, ps, batch_size=2, chunk=chunk, device="cpu",
                             compute_dtype=torch.float32, num_workers=2)
    ev, ie, pred = eng.predict_clips(_dataset(PD, tree, pcfg, **WIRE[wire]))
    jds = _dataset(JD, tree, jcfg, **WIRE[wire])
    ref_ev, ref_ie = _jax_scores(fwd, jp, js, [jds[i] for i in range(len(jds))])
    assert ev.shape == (N_CLIPS, 28) and ie.shape == pred.shape == (N_CLIPS, jcfg.num_frames)
    np.testing.assert_allclose(ev, ref_ev, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ie, ref_ie, atol=ATOL, rtol=RTOL)
    pos = 1.0 / (1.0 + np.exp(-ref_ie)) > 0.5
    np.testing.assert_array_equal(pred, np.where(pos, ref_ev.argmax(-1)[:, None], 28))


class Clips:
    """An in-memory map-style dataset: int16 wave and uint8 frames, each
    clip distinct."""

    def __init__(self, n, cfg, seed=0):
        rs = np.random.RandomState(seed)
        T, L, S = cfg.num_frames, cfg.htsat.frontend.clip_samples, cfg.swin.img_size
        self.wave = (np.clip(rs.randn(n, T, L) * 0.3, -1, 1) * 32767).astype(np.int16)
        self.frames = rs.randint(0, 256, (n, T, S, S, 3), dtype=np.uint8)

    def __len__(self):
        return len(self.wave)

    def __getitem__(self, i):
        return {"wave": self.wave[i], "image": self.frames[i]}


@pytest.mark.parametrize("n,chunk,want", [
    (7, 2, [[[0, 1], [2, 3]], [[4, 5], [6]]]),
    (5, 2, [[[0, 1], [2, 3]], [[4], []]]),
    (7, 3, [[[0, 1], [2, 3], [4, 5]], [[6], [], []]]),
])
def test_chunk_batches_pad_and_ids(model, n, chunk, want):
    _, pcfg, _, _, pp, ps, _ = model
    ds = Clips(n, pcfg)
    eng = AVEInferenceEngine(pcfg, pp, ps, batch_size=2, chunk=chunk, device="cpu",
                             compute_dtype=torch.float32, num_workers=2)
    blocks = list(eng._chunk_batches(ds))
    assert [ids for _, ids in blocks] == want
    last = blocks[-1][0]
    for k, arr in (("wave", ds.wave), ("image", ds.frames)):
        flat = np.concatenate([b[k].reshape((-1,) + arr.shape[1:]) for b, _ in blocks])
        np.testing.assert_array_equal(flat[:n], arr)
        np.testing.assert_array_equal(flat[n:], np.broadcast_to(arr[-1], flat[n:].shape))
        assert last[k].shape == (chunk, 2) + arr.shape[1:]


def test_predict_clips_equals_predict(model):
    """The stream and the in-memory request path give the same scores on
    the same clips (7 clips, B=2, chunk=2: a ragged batch)."""
    _, pcfg, _, _, pp, ps, _ = model
    ds = Clips(N_CLIPS, pcfg, seed=1)
    eng = AVEInferenceEngine(pcfg, pp, ps, batch_size=2, chunk=2, device="cpu",
                             compute_dtype=torch.float32, num_workers=2)
    ev, ie, pred = eng.predict_clips(ds)
    ref = eng.predict(ds.wave, ds.frames)
    np.testing.assert_allclose(ev, ref["event_scores"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(ie, ref["is_event_scores"], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(pred, ref["segment_preds"])
    outs = list(eng.stream(ds))
    assert len(outs) == 2
    assert outs[0][0]["event_scores"].shape == (2, 2, 28)
    assert outs[0][0]["is_event_scores"].shape == (2, 2, pcfg.num_frames)


def test_engine_defaults_follow_the_jax_engine(model):
    """float32 with default arguments serves exact GELU (the reference's),
    equal to gelu="exact"; bf16 resolves to tanh and the bf16 STFT."""
    _, pcfg, _, _, pp, ps, _ = model
    ds = Clips(2, pcfg, seed=2)
    kw = dict(batch_size=2, device="cpu", compute_dtype=torch.float32)
    default = AVEInferenceEngine(pcfg, pp, ps, **kw)
    assert default.gelu == "exact" and default.cfg.htsat.frontend.stft_compute is None
    got = default.predict(ds.wave, ds.frames)
    ref = AVEInferenceEngine(pcfg, pp, ps, gelu="exact", **kw).predict(ds.wave, ds.frames)
    tanh = AVEInferenceEngine(pcfg, pp, ps, gelu="tanh", **kw).predict(ds.wave, ds.frames)
    for k in ("event_scores", "is_event_scores"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert not np.array_equal(got["event_scores"], tanh["event_scores"])
    bf = AVEInferenceEngine(pcfg, pp, ps, batch_size=2, device="cpu")
    assert bf.gelu == "tanh" and bf.cfg.htsat.frontend.stft_compute == torch.bfloat16
    plain = AVEInferenceEngine(pcfg, pp, ps, device="cpu", stft_bf16=False)
    assert plain.gelu == "tanh" and plain.cfg.htsat.frontend.stft_compute is None
    assert (plain.B, plain.chunk, plain.prefetch, plain.num_workers) == (4, 8, 2, 8)
