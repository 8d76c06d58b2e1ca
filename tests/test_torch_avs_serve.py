"""The port's AVS serving and import (dg_sct_tpu_torch: data.avs, data.fbank,
serve.AVSInferenceEngine, the AVS part of utils.torch_convert,
tools.import_eval --task avs) against the JAX package, on the CPU in
float32 (JAX at matmul precision "highest"): the S4 dataset's items equal
JAX's; the engine's streamed masks and metas over an on-disk AVSBench tree
(4 clips at B=3, chunk=2: a ragged batch and a padded chunk) against JAX's
AVSInferenceEngine at atol 2e-4 / rtol 2e-3 on the logits, uint8 masks
within 0.5/255 of sigmoid(logits); int16 and mu-law waves dequantized on
the way in; the converter leaf for leaf against JAX's on a tiny state dict
and on the full key census of the AVS S4 checkpoint, PVT-v2-b5 included,
with the same census report and no unexplained key; the tool's gates and
exit codes."""
import numpy as np
import pytest
import torch

from dg_sct_tpu.data import avs as JD
from dg_sct_tpu.data import fbank as JF
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.serve import AVSInferenceEngine as JAXEngine
from dg_sct_tpu.tools import import_eval as JIE
from dg_sct_tpu.utils import checkpoint as JCK
from dg_sct_tpu.utils import torch_convert as JTC
from dg_sct_tpu_torch.configs import AVSModelConfig, ave_adapter_dims
from dg_sct_tpu_torch.data import avs as PD
from dg_sct_tpu_torch.data import fbank as PF
from dg_sct_tpu_torch.models import avs as PAvs
from dg_sct_tpu_torch.ops.basic import encode_mulaw_u8
from dg_sct_tpu_torch.serve import AVSInferenceEngine
from dg_sct_tpu_torch.tools import import_eval
from dg_sct_tpu_torch.utils import torch_convert as PTC
from dg_sct_tpu_torch.weights import from_jax
import media_tree
from test_torch_avs import port_avs_cfg, scramble_avs, tiny_avs_variant_cfg
from test_torch_checkpoint_import import assert_trees_equal, census_sd, digest
from test_torch_convert import fake_torch_sd
from torch_port_helpers import to_numpy

ATOL, RTOL = 2e-4, 2e-3
VIDEOS = [("guitar", f"s{i}") for i in range(3)] + [("drum", "s3")]
SEGMENT = 3200  # the tiny frontend's clip_samples


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores; a full set of intra-op threads
    in each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_avs_variant_cfg()
    pcfg = port_avs_cfg(jcfg)
    jp, js = scramble_avs(*(to_numpy(t) for t in PAvs.init_avs_model(pcfg, device="cpu")))
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    return jcfg, pcfg, jp, js, pp, ps


@pytest.fixture(scope="module")
def tree(tmp_path_factory, model):
    jcfg = model[0]
    root = str(tmp_path_factory.mktemp("avs_tree"))
    media_tree.make_avs_tree(root, VIDEOS, split="test", n_frames=jcfg.num_frames,
                             img_size=80, wave_samples=jcfg.num_frames * SEGMENT - 700,
                             mask_frames=jcfg.num_frames)
    return root


def _dataset(mod, root, cfg, **kw):
    return mod.S4Dataset(root, "test", mask_num=cfg.num_frames, img_size=cfg.mask_size,
                         num_frames=cfg.num_frames, segment_samples=SEGMENT, **kw)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_s4_dataset_matches_jax(model, tree):
    jcfg, pcfg = model[:2]
    pds, jds = _dataset(PD, tree, pcfg), _dataset(JD, tree, jcfg)
    assert pds.videos == jds.videos == sorted(VIDEOS)
    for i in range(len(jds)):
        got, ref = pds[i], jds[i]
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v
    assert got["image"].shape == (pcfg.num_frames, pcfg.mask_size, pcfg.mask_size, 3)
    assert got["wave"].shape == (pcfg.num_frames, SEGMENT)  # tiled from a short file


def test_log_mel_fields_match_jax(model, tree):
    """with_log_mel: the Kaldi-fbank stack (the port's own fbank copy)."""
    jcfg, pcfg = model[:2]
    got = _dataset(PD, tree, pcfg, with_log_mel=True)[0]["total_audio"]
    ref = _dataset(JD, tree, jcfg, with_log_mel=True)[0]["total_audio"]
    assert got.shape == (pcfg.num_frames, 192, 192)
    np.testing.assert_array_equal(got, ref)
    wave = np.random.RandomState(0).randn(16000).astype(np.float32)
    np.testing.assert_array_equal(PF.kaldi_fbank(wave), JF.kaldi_fbank(wave))


def test_synthetic_batch_matches_jax():
    got, ref = PD.synthetic_batch(2, img_size=32, seed=3), JD.synthetic_batch(2, img_size=32,
                                                                             seed=3)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_logits(model, tree):
    """JAX's engine in float32 with f32 logit transport, over the tree."""
    jcfg, _, jp, js, _, _ = model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")  # the parity form, whatever ran before
        eng = JAXEngine(jcfg, jp, js, batch_size=3, chunk=2, compute_dtype=np.float32,
                        mask_u8=False)
        out = list(eng.stream_masks(_dataset(JD, tree, jcfg)))
    return np.concatenate([m for m, _ in out]), [x for _, metas in out for x in metas]


def _stream(eng, ds):
    out = list(eng.stream_masks(ds))
    return np.concatenate([m for m, _ in out]), [x for _, metas in out for x in metas], out


def test_engine_matches_jax(model, tree, jax_logits):
    _, pcfg, _, _, pp, ps = model
    ref, ref_metas = jax_logits
    ds = _dataset(PD, tree, pcfg)
    kw = dict(batch_size=3, chunk=2, device="cpu", compute_dtype=torch.float32, num_workers=2)
    logits, metas, chunks = _stream(AVSInferenceEngine(pcfg, pp, ps, mask_u8=False, **kw), ds)
    T, S = pcfg.num_frames, pcfg.mask_size
    assert logits.shape == ref.shape == (len(VIDEOS), T, S, S) and logits.dtype == np.float32
    assert metas == ref_metas == ds.videos
    assert len(chunks) == 1 and [len(m) for _, m in chunks] == [len(VIDEOS)]
    np.testing.assert_allclose(logits, ref, atol=ATOL, rtol=RTOL)
    masks, metas_u8, _ = _stream(AVSInferenceEngine(pcfg, pp, ps, **kw), ds)
    assert metas_u8 == metas and masks.dtype == np.float32
    assert (masks >= 0).all() and (masks <= 1).all()
    prob = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    assert np.abs(masks - prob).max() <= 0.5 / 255 + 1e-6
    jax_u8 = np.round(1.0 / (1.0 + np.exp(-ref.astype(np.float64))) * 255.0) / 255.0
    assert np.abs(masks - jax_u8).max() <= 1.0 / 255 + 1e-6  # a rounding step apart at most


class Clips:
    """In-memory clips: float images and a wave in one of the wire formats."""

    def __init__(self, n, cfg, wave_format, seed=0):
        rs = np.random.RandomState(seed)
        T, S = cfg.num_frames, cfg.mask_size
        self.wave_f = np.clip(0.3 * rs.randn(n, T, cfg.htsat.frontend.clip_samples), -1, 1)
        self.wave = {"float": self.wave_f.astype(np.float32),
                     "int16": (self.wave_f * 32767).astype(np.int16),
                     "mulaw": encode_mulaw_u8(self.wave_f.astype(np.float32))}[wave_format]
        self.image = rs.rand(n, T, S, S, 3).astype(np.float32)
        self.videos = [("c", f"v{i}") for i in range(n)]

    def __len__(self):
        return len(self.wave)

    def __getitem__(self, i):
        return {"wave": self.wave[i], "image": self.image[i], "category": self.videos[i][0],
                "video": self.videos[i][1]}


@pytest.mark.parametrize("wave_format", ["int16", "mulaw"])
def test_engine_dequantizes_the_wave(model, wave_format):
    """int16 PCM and mu-law uint8 waves go through the engines' shared
    dequantize step (JAX's AVS engine only casts them): the same masks as
    the float wave they decode to."""
    from dg_sct_tpu_torch.ops.basic import dequantize_mulaw_u8

    _, pcfg, _, _, pp, ps = model
    ds = Clips(3, pcfg, wave_format)
    eng = AVSInferenceEngine(pcfg, pp, ps, batch_size=2, chunk=2, device="cpu",
                             compute_dtype=torch.float32, num_workers=2, mask_u8=False)
    got, metas, _ = _stream(eng, ds)
    decoded = (ds.wave.astype(np.float32) / 32767.0 if wave_format == "int16"
               else dequantize_mulaw_u8(torch.from_numpy(ds.wave)).numpy())
    ref_ds = Clips(3, pcfg, "float")
    ref_ds.wave = decoded.astype(np.float32)
    ref, _, _ = _stream(eng, ref_ds)
    assert metas == ds.videos
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_engine_normalizes_uint8_frames(model):
    """uint8 frames are ImageNet-normalized on the way in (JAX's AVS engine
    only casts them): the same masks as the float32 frames S4Dataset's
    `load_image` makes of the same pixels."""
    from dg_sct_tpu_torch.data.ave import IMAGENET_MEAN, IMAGENET_STD

    _, pcfg, _, _, pp, ps = model
    ds = Clips(3, pcfg, "float")
    ds.image = np.random.RandomState(1).randint(0, 256, ds.image.shape, dtype=np.uint8)
    eng = AVSInferenceEngine(pcfg, pp, ps, batch_size=2, chunk=2, device="cpu",
                             compute_dtype=torch.float32, num_workers=2, mask_u8=False)
    got, metas, _ = _stream(eng, ds)
    ref_ds = Clips(3, pcfg, "float")
    ref_ds.image = ((ds.image.astype(np.float32) / 255.0 - IMAGENET_MEAN)
                    / IMAGENET_STD).astype(np.float32)
    ref, _, _ = _stream(eng, ref_ds)
    assert metas == ds.videos
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_chunk_batches_pad_and_metas(model):
    _, pcfg, _, _, pp, ps = model
    ds = Clips(4, pcfg, "float")
    eng = AVSInferenceEngine(pcfg, pp, ps, batch_size=3, chunk=2, device="cpu",
                             compute_dtype=torch.float32, num_workers=2)
    blocks = list(eng._chunk_batches(ds))
    assert [ids for _, ids in blocks] == [[ds.videos[:3], ds.videos[3:]]]
    img = blocks[0][0]["image"]
    assert img.shape == (2, 3) + ds.image.shape[1:]
    np.testing.assert_array_equal(img[1, 1:], np.broadcast_to(ds.image[3], img[1, 1:].shape))


def test_engine_options(model, monkeypatch):
    _, pcfg, _, _, pp, ps = model
    eng = AVSInferenceEngine(pcfg, pp, ps, device="cpu")
    assert (eng.B, eng.chunk, eng.prefetch, eng.num_workers, eng.mask_u8) == (2, 4, 2, 8, True)
    assert eng.gelu == "tanh" and eng.params["swin"]["norm"]["scale"].dtype == torch.bfloat16
    assert AVSInferenceEngine(pcfg, pp, ps, device="cpu",
                              compute_dtype=torch.float32).gelu == "exact"
    with pytest.raises(ValueError):
        AVSInferenceEngine(pcfg, pp, ps, device="cpu", gelu="erf")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AVSInferenceEngine(pcfg, pp, ps)


# ---------------------------------------------------------------------------
# the converter and the tool
# ---------------------------------------------------------------------------

def fake_avs_sd(jcfg):
    """A `Pred_endecoder` state dict at tiny widths: the towers and adapters
    of `fake_torch_sd` (no adapter BN, a gate on the visual adapters only),
    the AVS heads, TPAVI, the FPN, a PVT-v2-b5 of tiny widths under
    `encoder_backbone.`, and dead keys of each documented ignore pattern."""
    rs = np.random.RandomState(1)
    sd = {}
    for k, v in fake_torch_sd(jcfg).items():
        if k.startswith(("temporal_attn.", "CMBS.")) or ".bn1." in k or ".bn2." in k:
            continue
        if k.startswith("audio_adapter_blocks") and k.endswith(".gate"):
            continue
        sd[k] = v

    def add(name, *shape):
        if name.endswith("running_var"):
            sd[name] = rs.rand(*shape).astype(np.float32) + 0.5
        else:
            sd[name] = (0.05 * rs.randn(*shape)).astype(np.float32)

    def linear(name, o, i):
        add(f"{name}.weight", o, i)
        add(f"{name}.bias", o)

    def norm(name, d, bn=False):
        for n in ("weight", "bias") + (("running_mean", "running_var") if bn else ()):
            add(f"{name}.{n}", d)
        if bn:
            sd[f"{name}.num_batches_tracked"] = np.asarray(3, np.int64)

    C, FFN = jcfg.channel, 1024
    for i in range(4):
        linear(f"x{i + 1}_linear_", C, jcfg.swin.stage_dim(i))
        linear(f"x{i + 1}_linear", C, 8)  # dead
        add(f"conv{i + 1}.conv2d_list.0.weight", 2, 8, 3, 3)  # dead
    linear("audio_linear", C // 2, jcfg.htsat.num_features)

    def layer(p, dec=False):
        for att in ("self_attn",) + (("multihead_attn",) if dec else ()):
            add(f"{p}.{att}.in_proj_weight", 3 * C, C)
            add(f"{p}.{att}.in_proj_bias", 3 * C)
            linear(f"{p}.{att}.out_proj", C, C)
        linear(f"{p}.linear1", FFN, C)
        linear(f"{p}.linear2", C, FFN)
        norm(f"{p}.norm1", C)
        norm(f"{p}.norm2", C)

    ta = "temporal_attn"
    for i in range(4):
        linear(f"{ta}.v_fc.{i}", C, C)
        for name, hid, ih in (("audio_rnn", C // 2, C // 2), ("visual_rnn", C, C)):
            for sfx in ("", "_reverse"):
                pre = f"{ta}.audio_visual_rnn_layer.{i}.{name}"
                add(f"{pre}.weight_ih_l0{sfx}", 4 * hid, ih)
                add(f"{pre}.weight_hh_l0{sfx}", 4 * hid, hid)
                add(f"{pre}.bias_ih_l0{sfx}", 4 * hid)
                add(f"{pre}.bias_hh_l0{sfx}", 4 * hid)
        for name, ind in (("video", 2 * C), ("audio", C)):
            linear(f"{ta}.{name}_encoder.{i}.affine_matrix", C, ind)
            for j in range(2):
                layer(f"{ta}.{name}_encoder.{i}.encoder.layers.{j}")
            layer(f"{ta}.{name}_encoder.{i}.encoder_layer")  # the dead prototype
            linear(f"{ta}.{name}_decoder.{i}.affine_matrix", C, ind)
            layer(f"{ta}.{name}_decoder.{i}.decoder.layers.0", dec=True)
            linear(f"{ta}.{name}_gated.{i}.0", 1, C)
        linear(f"{ta}.temporal_gated.{i}.0", 1, C)  # dead
    for i in range(4):
        for u in (1, 2):
            for c in (1, 2):
                add(f"path{i + 1}.resConfUnit{u}.conv{c}.weight", C, C, 3, 3)
                add(f"path{i + 1}.resConfUnit{u}.conv{c}.bias", C)
    for idx, o, i, k in ((0, 128, C, 3), (2, 32, 128, 3), (4, 1, 32, 1)):
        add(f"output_conv.{idx}.weight", o, i, k, k)
        add(f"output_conv.{idx}.bias", o)
    for s in jcfg.tpavi_stages:
        p = f"tpavi_b{s + 1}"
        linear(f"{p}.align_channel", C, C // 2)
        norm(f"{p}.norm_layer", C)
        for n in ("g", "theta", "phi"):
            add(f"{p}.{n}.weight", C // 2, C, 1, 1, 1)
            add(f"{p}.{n}.bias", C // 2)
        add(f"{p}.W_z.0.weight", C, C // 2, 1, 1, 1)
        add(f"{p}.W_z.0.bias", C)
        norm(f"{p}.W_z.1", C, bn=True)
    d = 4  # PVT-v2-b5 at depths (3, 6, 40, 3), width 4
    for s, depth in enumerate((3, 6, 40, 3)):
        pre = "encoder_backbone."
        add(f"{pre}patch_embed{s + 1}.proj.weight", d, 3 if s == 0 else d, 3, 3)
        add(f"{pre}patch_embed{s + 1}.proj.bias", d)
        norm(f"{pre}patch_embed{s + 1}.norm", d)
        norm(f"{pre}norm{s + 1}", d)
        for b in range(depth):
            p = f"{pre}block{s + 1}.{b}"
            norm(f"{p}.norm1", d)
            norm(f"{p}.norm2", d)
            linear(f"{p}.attn.q", d, d)
            linear(f"{p}.attn.kv", 2 * d, d)
            linear(f"{p}.attn.proj", d, d)
            linear(f"{p}.mlp.fc1", 2 * d, d)
            add(f"{p}.mlp.dwconv.dwconv.weight", 2 * d, 1, 3, 3)
            add(f"{p}.mlp.dwconv.dwconv.bias", 2 * d)
            linear(f"{p}.mlp.fc2", d, 2 * d)
            if s < 3:
                add(f"{p}.attn.sr.weight", d, d, 2, 2)
                add(f"{p}.attn.sr.bias", d)
                norm(f"{p}.attn.norm", d)
    return sd


def _convert_with_report(mod, sd, *args):
    """`convert_avs_model` of a tracked copy of `sd` -> (tree, census report)."""
    tsd = mod.track(dict(sd))
    tree = mod.convert_avs_model(tsd, *args)
    return tree, mod.census_report(tsd, mod.AVS_CKPT_IGNORED_PATTERNS)


@pytest.fixture(scope="module")
def tiny_sd(model):
    return fake_avs_sd(model[0])


def _tiny_args(jcfg):
    return len(ave_adapter_dims(jcfg.swin, jcfg.htsat)), 2, jcfg.tpavi_stages


def test_tiny_converter_equals_jax(model, tiny_sd):
    jcfg, pcfg = model[:2]
    (pp, ps, ppvt), prep = _convert_with_report(PTC, tiny_sd, *_tiny_args(jcfg))
    (jp, js, jpvt), jrep = _convert_with_report(JTC, tiny_sd, *_tiny_args(jcfg))
    assert_trees_equal(pp, jp, "params")
    assert_trees_equal(ps, js, "state")
    assert_trees_equal(ppvt, jpvt, "pvt")
    assert len(ppvt["stages"][2]["blocks"]) == 40
    assert prep == jrep and not prep["unexplained"] and len(prep["ignored"]) > 20
    assert sorted(prep["consumed"] + prep["ignored"]) == sorted(tiny_sd)
    tp, _ = from_jax(pp, ps, pcfg, device="cpu")
    assert tp["tpavi"]["tpavi_b1"]["g"]["kernel"].shape == (pcfg.channel, pcfg.channel // 2)


def test_full_width_avs_census():
    """The AVS S4 checkpoint's census: both converters give the same tree,
    PVT-v2-b5 included, and the same report, no key is unexplained, and
    `from_jax` takes the tree on the meta device at AVSModelConfig(). JAX's
    tree is kept as a digest only, so one full-width tree is in memory at a
    time."""
    sd = census_sd("census_avs_s4.json")
    assert len(sd) == 3913
    jtree, jrep = _convert_with_report(JTC, sd)
    jax_digest = digest(jtree)
    del jtree
    (pp, ps, ppvt), prep = _convert_with_report(PTC, sd)
    assert digest((pp, ps, ppvt)) == list(jax_digest)
    assert prep == jrep and not prep["unexplained"]
    assert sum(k.startswith("encoder_backbone.") for k in prep["consumed"]) == 1052
    tp, _ = from_jax(pp, ps, AVSModelConfig(), device="meta")
    assert tp["scale_linears"][0]["kernel"].shape == (192, 256)
    assert tp["paths"][0]["res1"]["conv1"]["kernel"].shape == (3, 3, 256, 256)


def _save_sd(sd, path):
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, str(path))
    return str(path)


def test_import_eval_avs(model, tiny_sd, tmp_path, capsys):
    jcfg, cfg = model[:2]
    pt = _save_sd(tiny_sd, tmp_path / "S4_pvt_best.pth")
    out = tmp_path / "converted.npz"
    assert import_eval.main(["--task", "avs", "--ckpt", pt, "--census-only", "--save",
                             str(out)], cfg=cfg) is None
    text = capsys.readouterr().out
    assert "0 UNEXPLAINED" in text and "shape audit: OK" in text
    # the JAX package reads the bundle as it reads its own tool's
    jp, js, jpvt = JTC.convert_avs_model(dict(tiny_sd), *_tiny_args(jcfg))
    JCK.save_params(str(tmp_path / "jax.npz"), {"params": jp, "state": js, "pvt_backbone": jpvt})
    bundle = JCK.load_params(str(out))
    assert sorted(bundle) == ["params", "pvt_backbone", "state"]
    assert_trees_equal(bundle, JCK.load_params(str(tmp_path / "jax.npz")))

    extra = _save_sd({**tiny_sd, "mystery.weight": np.zeros(3, np.float32)}, tmp_path / "x.pth")
    with pytest.raises(SystemExit) as e:
        import_eval.main(["--task", "avs", "--ckpt", extra, "--census-only"], cfg=cfg)
    assert e.value.code == 2
    bad = _save_sd({**tiny_sd, "audio_linear.weight": np.zeros((3, 7), np.float32)},
                   tmp_path / "bad.pth")
    with pytest.raises(SystemExit) as e:
        import_eval.main(["--task", "avs", "--ckpt", bad], cfg=cfg)
    assert e.value.code == 3
    # an AVS checkpoint under --task avqa: the AVQA converter stops at its
    # first missing key, before the census, as the JAX tool does on the file
    with pytest.raises(KeyError) as e:
        import_eval.main(["--task", "avqa", "--ckpt", pt, "--census-only"])
    with pytest.raises(KeyError) as j:
        JIE.import_task_checkpoint("avqa", pt)
    assert e.value.args == j.value.args
