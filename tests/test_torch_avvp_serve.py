"""The port's AVVP data, F1, serving and import (dg_sct_tpu_torch:
data.avvp, train.avvp_eval, serve.AVVPInferenceEngine, the AVVP part of
utils.torch_convert, tools.import_eval --task avvp) against the JAX
package on the CPU, float32 with JAX at matmul precision "highest".

The LLP dataset's items and both csv parsers equal JAX's (its pandas parse,
row for row); the segment- and event-level F1 equal JAX's on seeded
predictions, empty and full grids included; the engine's streamed
probabilities and video ids over 5 clips (B=2, chunk=2: a ragged batch and
a padded chunk) against JAX's forward at atol 2e-4 / rtol 2e-3, and int16
and uint8 wire formats against the float wave and frames they decode to
(atol 1e-5); the converter leaf for leaf against JAX's on a tiny MGN_Net
state dict (its converted forward against JAX's) and on the full key
census of the AVVP checkpoint, with the same census report and no
unexplained key; the tool's gates and exit codes."""
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from dg_sct_tpu.data import avvp as JD
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.train import avvp_eval as JE
from dg_sct_tpu.utils import checkpoint as JCK
from dg_sct_tpu.utils import torch_convert as JTC
from dg_sct_tpu_torch.configs import AVVPModelConfig, ave_adapter_dims
from dg_sct_tpu_torch.data import avvp as PD
from dg_sct_tpu_torch.models import avvp as PV
from dg_sct_tpu_torch.ops.basic import IMAGENET_MEAN, IMAGENET_STD
from dg_sct_tpu_torch.serve import AVVP_OUTPUTS, AVVPInferenceEngine
from dg_sct_tpu_torch.tools import import_eval
from dg_sct_tpu_torch.train import avvp_eval as PE
from dg_sct_tpu_torch.utils import torch_convert as PTC
from dg_sct_tpu_torch.weights import from_jax
import media_tree
from refgold_common import synth
from test_torch_avvp import (few_torch_threads, jax_forward, port_avvp_cfg,  # noqa: F401
                             tiny, tiny_avvp_cfg)
from test_torch_checkpoint_import import assert_shapes, assert_trees_equal, census_sd, digest
from test_torch_convert import fake_torch_sd

ATOL, RTOL = 2e-4, 2e-3
GOLD = Path(__file__).resolve().parent / "golden"
VIDEOS = ["aaaaaaaaaaa_0_10", "bbbbbbbbbbb_5_15", "ccccccccccc_2_12"]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llp_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("llp"))
    cfg = tiny_avvp_cfg()
    return root, media_tree.make_llp_tree(
        root, VIDEOS, n_frames=3, img_size=80,
        wave_samples=cfg.num_frames * cfg.htsat.frontend.clip_samples - 500)


@pytest.mark.parametrize("with_st", [True, False], ids=["st", "no_st"])
def test_llp_dataset_matches_jax(llp_tree, with_st):
    root, t = llp_tree
    cfg = tiny_avvp_cfg()
    kw = dict(frame_dir=t["frames"], audio_dir=t["audio"], st_dir=t["st"] if with_st else None,
              img_size=cfg.swin.img_size, num_frames=cfg.num_frames,
              segment_samples=cfg.htsat.frontend.clip_samples)
    csv = os.path.join(root, "AVVP_train.csv")
    pds, jds = PD.LLPDataset(csv, **kw), JD.LLPDataset(csv, **kw)
    assert len(pds) == len(jds) == 3
    for i in range(3):
        got, ref = pds[i], jds[i]
        assert sorted(got) == sorted(ref) and ("video_st" in got) == with_st
        for k, v in ref.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v == VIDEOS[i][:11]


def test_llp_dataset_resamples_st(tmp_path):
    """r2plus1d features of another length are sampled to num_frames, as JAX."""
    root = str(tmp_path)
    t = media_tree.make_llp_tree(root, VIDEOS[:1], n_frames=2, img_size=64, wave_samples=900)
    np.save(os.path.join(t["st"], f"{VIDEOS[0][:11]}.npy"),
            np.arange(16 * 512, dtype=np.float32).reshape(16, 512))
    kw = dict(frame_dir=t["frames"], audio_dir=t["audio"], st_dir=t["st"], img_size=64,
              num_frames=10, segment_samples=300)
    csv = os.path.join(root, "AVVP_train.csv")
    got, ref = PD.LLPDataset(csv, **kw)[0], JD.LLPDataset(csv, **kw)[0]
    np.testing.assert_array_equal(got["video_st"], ref["video_st"])
    assert got["video_st"].shape == (10, 512)


def test_csv_parsers_match_pandas(tmp_path):
    """Both layouts parsed by the csv module, row for row as JAX's pandas
    parse: multi-labels, unknown and empty labels, a blank line, float
    onsets, offsets past the last segment and repeated videos."""
    labels = tmp_path / "labels.csv"
    labels.write_text("filename\tevent_labels\n"
                      "aaaaaaaaaaa_0_10\tSpeech,Dog\n"
                      "bbbbbbbbbbb_1_11\tNot_a_class\n"
                      "\n"
                      "ccccccccccc_2_12\t\n"
                      "ddddddddddd_3_13\tClapping,Frying_(food),Speech\n")
    got, ref = PD.parse_label_csv(str(labels)), JD.parse_label_csv(str(labels))
    assert [v for v, _ in got] == [v for v, _ in ref] and len(got) == 4
    for (_, g), (_, r) in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    ann = tmp_path / "eval.csv"
    ann.write_text("filename\tonset\toffset\tevent_labels\n"
                   "aaaaaaaaaaa_0_10\t0\t3\tSpeech\n"
                   "aaaaaaaaaaa_0_10\t2.0\t12\tDog,Speech\n"
                   "bbbbbbbbbbb_1_11\t5\t6\tNot_a_class\n"
                   "\n"
                   "ccccccccccc_2_12\t9\t10\tBlender\n")
    for n in (10, 6):
        got, ref = PD.parse_eval_csv(str(ann), n), JD.parse_eval_csv(str(ann), n)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert PD.CATEGORIES == JD.CATEGORIES and PD.CAT_IDX == JD.CAT_IDX


def test_synthetic_batch_matches_jax():
    got, ref = PD.synthetic_batch(2, img_size=32, seed=3), JD.synthetic_batch(2, img_size=32,
                                                                             seed=3)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


# ---------------------------------------------------------------------------
# F1
# ---------------------------------------------------------------------------

def _grids(seed):
    """Seeded (25, 10) predictions and annotations, with an empty and a full
    class row on each side."""
    rs = np.random.RandomState(seed)
    grid = lambda p: (rs.rand(25, 10) < p).astype(np.int64)
    so_a, so_v, gt_a, gt_v = grid(0.3), grid(0.2), grid(0.3), grid(0.25)
    so_a[3], gt_a[4], so_v[5], gt_v[5] = 1, 1, 0, 0
    return so_a, so_v, gt_a, gt_v


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f1_matches_jax(seed):
    so_a, so_v, gt_a, gt_v = _grids(seed)
    grids = (so_a, so_v, so_a * so_v, gt_a, gt_v, gt_a * gt_v)
    assert PE.segment_level(*grids) == pytest.approx(JE.segment_level(*grids), rel=1e-12)
    assert PE.event_level(*grids) == pytest.approx(JE.event_level(*grids), rel=1e-12)
    for row in list(so_a) + [np.ones(10), np.zeros(10)]:
        got, ref = PE.extract_events(row), JE.extract_events(row)
        assert (got is None) == (ref is None)
        for g, r in zip(got or (), ref or ()):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("case", ["seeded", "empty", "full"])
def test_evaluate_video_and_summary_match_jax(case):
    rs = np.random.RandomState(7)
    per_p, per_j = [], []
    for v in range(3):
        out = {"global_prob": rs.rand(1, 25), "a_frame_prob": rs.rand(1, 10, 25),
               "v_frame_prob": rs.rand(1, 10, 25)}
        if case != "seeded":
            out = {k: np.full_like(a, 1.0 if case == "full" else 0.0) for k, a in out.items()}
        _, _, gt_a, gt_v = _grids(v)
        if case == "empty":
            gt_a, gt_v = np.zeros_like(gt_a), np.zeros_like(gt_v)
        per_j.append(JE.evaluate_video(out, gt_a, gt_v))
        got = PE.evaluate_video({k: torch.from_numpy(a) for k, a in out.items()}, gt_a, gt_v)
        assert got == pytest.approx(per_j[-1], rel=1e-12)
        per_p.append(got)
    assert PE.summarize(per_p) == pytest.approx(JE.summarize(per_j), rel=1e-12)
    if case == "empty":  # all true negatives
        assert all(v == 100.0 for v in PE.summarize(per_p).values())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class Clips:
    """In-memory LLP clips: float frames and wave, or uint8 frames and an
    int16 wave, with r2plus1d features and video ids."""

    def __init__(self, n, cfg, wire=False, seed=0):
        rs = np.random.RandomState(seed)
        T, S = cfg.num_frames, cfg.swin.img_size
        wave = np.clip(0.3 * rs.randn(n, T, cfg.htsat.frontend.clip_samples), -1, 1)
        frames = rs.randint(0, 256, (n, T, S, S, 3), dtype=np.uint8)
        self.video_st = rs.randn(n, T, 512).astype(np.float32)
        if wire:
            self.wave, self.image = (wave * 32767).astype(np.int16), frames
        else:
            self.wave = wave.astype(np.float32)
            self.image = rs.rand(n, T, S, S, 3).astype(np.float32)
        self.videos = [f"v{i:010d}" for i in range(n)]

    def decoded(self):
        """The float wave and frames the wire formats stand for."""
        if self.wave.dtype != np.int16:
            return self.wave, self.image
        mean, std = np.asarray(IMAGENET_MEAN, np.float32), np.asarray(IMAGENET_STD, np.float32)
        return (self.wave.astype(np.float32) / 32767.0,
                ((self.image.astype(np.float32) - 255.0 * mean) / (255.0 * std)).astype(
                    np.float32))

    def __len__(self):
        return len(self.wave)

    def __getitem__(self, i):
        return {"wave": self.wave[i], "image": self.image[i], "video_st": self.video_st[i],
                "video": self.videos[i]}


def _engine(t, **kw):
    return AVVPInferenceEngine(t["pcfg"], t["pp"], t["ps"], batch_size=2, chunk=2, device="cpu",
                               compute_dtype=torch.float32, num_workers=2, **kw)


def _stream(eng, ds):
    out = list(eng.stream_probs(ds))
    return ({k: np.concatenate([p[k] for p, _ in out]) for k in AVVP_OUTPUTS},
            [v for _, vids in out for v in vids], out)


def test_stream_probs_matches_jax(tiny):
    """5 clips at B=2, chunk 2: blocks of [[0, 1], [2, 3]] and [[4], []], the
    padding dropped, ids in dataset order; each output against JAX's
    forward of the same clips."""
    t = tiny
    ds = Clips(5, t["pcfg"], seed=3)
    probs, vids, blocks = _stream(_engine(t, gelu="exact"), ds)
    assert vids == ds.videos and [len(v) for _, v in blocks] == [4, 1]
    ref = {k: [] for k in AVVP_OUTPUTS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        for s in range(0, 5, 2):
            idx = list(range(s, min(s + 2, 5)))
            idx += [idx[-1]] * (2 - len(idx))
            out = t["fwd"](t["jp"], t["js"], ds.wave[idx], ds.image[idx], ds.video_st[idx])
            for k in AVVP_OUTPUTS:
                ref[k].append(np.asarray(out[k])[:min(2, 5 - s)])
    for k in AVVP_OUTPUTS:
        assert probs[k].shape == np.concatenate(ref[k]).shape, k
        np.testing.assert_allclose(probs[k], np.concatenate(ref[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    assert probs["a_frame_prob"].shape == (5, t["pcfg"].num_frames, 25)


def test_wire_formats_match_the_float_inputs(tiny):
    """int16 waves and uint8 frames dequantized on the way in give the
    outputs of the float wave and frames they decode to."""
    t = tiny
    wire = Clips(3, t["pcfg"], wire=True, seed=4)
    flt = Clips(3, t["pcfg"], seed=4)
    flt.wave, flt.image = wire.decoded()
    eng = _engine(t)
    got, vids, _ = _stream(eng, wire)
    ref, _, _ = _stream(eng, flt)
    assert vids == wire.videos
    for k in AVVP_OUTPUTS:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=1e-5, err_msg=k)


def test_chunk_batches_stage_video_st(tiny):
    """video_st is padded and chunked with the wave and the frames."""
    t = tiny
    ds = Clips(3, t["pcfg"], seed=5)
    blocks = list(_engine(t)._chunk_batches(ds))
    assert [ids for _, ids in blocks] == [[ds.videos[:2], ds.videos[2:]]]
    arrays = blocks[0][0]
    assert sorted(arrays) == ["image", "video_st", "wave"]
    st = arrays["video_st"]
    assert st.shape == (2, 2) + ds.video_st.shape[1:]
    np.testing.assert_array_equal(st.reshape((4,) + st.shape[2:])[:3], ds.video_st)
    np.testing.assert_array_equal(st[1, 1], ds.video_st[2])


def test_engine_options(tiny, monkeypatch):
    t = tiny
    eng = AVVPInferenceEngine(t["pcfg"], t["pp"], t["ps"], device="cpu")
    assert (eng.B, eng.chunk, eng.prefetch, eng.num_workers) == (4, 4, 2, 8)
    assert eng.gelu == "tanh" and eng.params["fc_st"]["kernel"].dtype == torch.bfloat16
    assert _engine(t).gelu == "exact"
    with pytest.raises(ValueError):
        _engine(t, gelu="erf")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AVVPInferenceEngine(t["pcfg"], t["pp"], t["ps"])


# ---------------------------------------------------------------------------
# the converter and the tool
# ---------------------------------------------------------------------------

HEAD_ROOTS = ("audio_cug.", "visual_cug.", "av_mcg.", "temporal_attn.", "fc_", "audio_token",
              "visual_token")


def census_cfg():
    """Tiny towers with the checkpoint's head widths (dim 128, depths 3/3/6,
    10 segments), so the census's head keys fit."""
    return dataclasses.replace(tiny_avvp_cfg(), dim=128, depth_aud=3, depth_vis=3, depth_av=6,
                               num_frames=10)


def fake_avvp_sd(jcfg):
    """An MGN_Net state dict at tiny tower widths: the towers and adapters
    of `fake_torch_sd`, the census's heads (fc_a and fc_v at the tiny
    towers' widths) from refgold_common.synth, and dead keys of each
    documented ignore pattern."""
    sd = {k: v for k, v in fake_torch_sd(jcfg).items()
          if not k.startswith(("temporal_attn.", "CMBS."))}
    with open(GOLD / "census_avvp_mgn.json") as f:
        census = json.load(f)
    d = jcfg.dim
    widths = {"fc_a.weight": (d, jcfg.htsat.num_features),
              "fc_v.weight": (d, jcfg.swin.num_features)}
    for k, spec in census.items():
        if k.startswith(HEAD_ROOTS):
            sd[k] = synth(k, widths.get(k, spec["shape"]))
    for lst in ("audio_adapter_blocks_p1", "vis_adapter_blocks_p2"):
        sd[f"{lst}.0.fc_caption.weight"] = synth(f"{lst}.fc_caption", (8, 4))
        sd[f"{lst}.0.temporal_gated.0.weight"] = synth(f"{lst}.temporal_gated", (1, 8))
    return sd


def _convert_with_report(mod, sd, cfg):
    tsd = mod.track(dict(sd))
    tree = mod.convert_avvp_model(tsd, len(ave_adapter_dims(cfg.swin, cfg.htsat)), 2,
                                  (cfg.depth_aud, cfg.depth_vis, cfg.depth_av))
    return tree, mod.census_report(tsd, mod.AVVP_CKPT_IGNORED_PATTERNS)


@pytest.fixture(scope="module")
def tiny_sd():
    return fake_avvp_sd(census_cfg())


def test_tiny_converter_equals_jax(tiny_sd):
    jcfg = census_cfg()
    (pp, ps), prep = _convert_with_report(PTC, tiny_sd, jcfg)
    (jp, js), jrep = _convert_with_report(JTC, tiny_sd, jcfg)
    assert_trees_equal(pp, jp, "params")
    assert_trees_equal(ps, js, "state")
    assert prep == jrep and not prep["unexplained"]
    assert any("fc_caption" in k for k in prep["ignored"])
    assert any(".encoder_layer." in k for k in prep["ignored"])
    assert sorted(prep["consumed"] + prep["ignored"]) == sorted(tiny_sd)


def test_tiny_converted_forward_matches_jax(tiny_sd):
    """The converted tree through from_jax and the port's forward against
    JAX's forward of JAX's converted tree."""
    jcfg = census_cfg()
    pcfg = port_avvp_cfg(jcfg)
    (jp, js), _ = _convert_with_report(JTC, tiny_sd, jcfg)
    (pp, ps), _ = _convert_with_report(PTC, tiny_sd, jcfg)
    tp, ts = from_jax(pp, ps, pcfg, device="cpu")
    rs = np.random.RandomState(6)
    T = jcfg.num_frames
    wave = (0.3 * rs.randn(1, T, jcfg.htsat.frontend.clip_samples)).astype(np.float32)
    imgs = rs.rand(1, T, jcfg.swin.img_size, jcfg.swin.img_size, 3).astype(np.float32)
    st = rs.randn(1, T, 512).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        ref = jax_forward(jcfg)(jp, js, wave, imgs, st)
    with torch.inference_mode():
        got = PV.forward(tp, ts, wave, imgs, st, pcfg, device="cpu", kernels=False)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_full_width_avvp_census():
    """The AVVP checkpoint's census: both converters give the same tree and
    the same report, no key is unexplained, and `from_jax` takes the tree on
    the meta device at AVVPModelConfig(). JAX's tree is kept as a digest
    only, so one full-width tree is in memory at a time."""
    sd = census_sd("census_avvp_mgn.json")
    assert len(sd) == 3110
    jtsd = JTC.track(dict(sd))
    jax_digest = digest(JTC.convert_avvp_model(jtsd))
    jrep = JTC.census_report(jtsd, JTC.AVVP_CKPT_IGNORED_PATTERNS)
    ptsd = PTC.track(dict(sd))
    pp, ps = PTC.convert_avvp_model(ptsd)
    prep = PTC.census_report(ptsd, PTC.AVVP_CKPT_IGNORED_PATTERNS)
    assert digest((pp, ps)) == list(jax_digest)
    assert prep == jrep and not prep["unexplained"] and len(prep["ignored"]) > 100
    tp, ts = from_jax(pp, ps, AVVPModelConfig(), device="meta")
    assert tp["audio_cug"]["han_encoder"]["mlp_inter"]["fc1"]["kernel"].shape == (10, 64)
    assert tp["fc_a"]["kernel"].shape == (768, 128)
    assert len(tp["av_mcg"]["blocks"]) == 6


def test_full_width_avvp_htsat_census():
    """The pre-finetune HTS-AT checkpoint the AVVP model starts from (its own
    census): both converters give the same tree and report, nothing is
    unexplained, and the tree has the AVVP model's htsat shapes."""
    sd = census_sd("census_htsat_audioset_avvp.json", prefix="sed_model.")
    jtsd, ptsd = JTC.track(dict(sd)), PTC.track(dict(sd))
    jtree, ptree = JTC.convert_htsat(jtsd), PTC.convert_htsat(ptsd)
    assert digest(ptree) == digest(jtree)
    prep = PTC.census_report(ptsd, PTC.AVVP_CKPT_IGNORED_PATTERNS)
    assert prep == JTC.census_report(jtsd, JTC.AVVP_CKPT_IGNORED_PATTERNS)
    assert not prep["unexplained"]
    ref_p, ref_s = PV.init_avvp_model(AVVPModelConfig(), device="meta")
    assert_shapes(ptree[0], ref_p["htsat"], "htsat params")
    assert_shapes(ptree[1], ref_s["htsat"], "htsat state")


def _save_sd(sd, path):
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, str(path))
    return str(path)


def test_import_eval_avvp(tiny_sd, tmp_path, capsys):
    jcfg = census_cfg()
    cfg = port_avvp_cfg(jcfg)
    pt = _save_sd(tiny_sd, tmp_path / "MGN_Net.pt")
    out = tmp_path / "converted.npz"
    assert import_eval.main(["--task", "avvp", "--ckpt", pt, "--census-only", "--save",
                             str(out)], cfg=cfg) is None
    text = capsys.readouterr().out
    assert "0 UNEXPLAINED" in text and "shape audit: OK" in text
    # the JAX package reads the bundle, and it holds JAX's converted tree
    (jp, js), _ = _convert_with_report(JTC, tiny_sd, jcfg)
    bundle = JCK.load_params(str(out))
    assert sorted(bundle) == ["params", "state"]
    assert_trees_equal(bundle, {"params": jp, "state": js})

    extra = _save_sd({**tiny_sd, "mystery.weight": np.zeros(3, np.float32)}, tmp_path / "x.pt")
    with pytest.raises(SystemExit) as e:
        import_eval.main(["--task", "avvp", "--ckpt", extra, "--census-only"], cfg=cfg)
    assert e.value.code == 2
    assert import_eval.main(["--task", "avvp", "--ckpt", extra, "--lax"], cfg=cfg) is None
    bad = _save_sd({**tiny_sd, "fc_st.weight": np.zeros((128, 7), np.float32)},
                   tmp_path / "bad.pt")
    with pytest.raises(SystemExit) as e:
        import_eval.main(["--task", "avvp", "--ckpt", bad], cfg=cfg)
    assert e.value.code == 3
