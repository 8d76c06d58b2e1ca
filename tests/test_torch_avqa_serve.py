"""The port's AVQA data, serving and import (dg_sct_tpu_torch: data.avqa,
serve.AVQAInferenceEngine, the AVQA part of utils.torch_convert,
tools.import_eval --task avqa / avqa_grounding) against the JAX package on
the CPU, float32 with JAX at matmul precision "highest".

The vocabularies, question parsing and tokenizing (truncation, unknown
words), the dataset's items (the negative videos drawn in the same
sequence) and the per-type accuracies (a malformed type included) equal
JAX's; the engine's streamed logits and metas over 5 questions (B=2, chunk
2: a ragged batch and a padded chunk) against the JAX engine's at atol 2e-4
/ rtol 2e-3, both folding the adapters; int16 and uint8 wire formats
against the float wave and frames they decode to (atol 1e-5); the
converters leaf for leaf against JAX's on tiny state dicts of both
checkpoints and on the full key censuses, with the same census reports and
no unexplained key; the tool's exit codes."""
import json
import os
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.data import avqa as JD
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.serve import AVQAInferenceEngine as JAVQAEngine
from dg_sct_tpu.utils import checkpoint as JCK
from dg_sct_tpu.utils import torch_convert as JTC
from dg_sct_tpu_torch.configs import AVQAModelConfig, ave_adapter_dims
from dg_sct_tpu_torch.data import avqa as PD
from dg_sct_tpu_torch.models import avqa as PA
from dg_sct_tpu_torch.models import avqa_grounding as PG
from dg_sct_tpu_torch.ops.basic import IMAGENET_MEAN, IMAGENET_STD
from dg_sct_tpu_torch.serve import AVQAInferenceEngine
from dg_sct_tpu_torch.tools import import_eval
from dg_sct_tpu_torch.utils import torch_convert as PTC
from dg_sct_tpu_torch.weights import from_jax
import media_tree
from refgold_common import synth
from test_torch_avqa import few_torch_threads, port_avqa_cfg, scramble_avqa  # noqa: F401
from test_torch_avqa import tiny_avqa4_cfg
from test_torch_checkpoint_import import assert_trees_equal, census_sd, digest
from test_torch_convert import fake_torch_sd
from torch_port_helpers import to_numpy

ATOL, RTOL = 2e-4, 2e-3
GOLD = Path(__file__).resolve().parent / "golden"
VIDEOS = ["qa0", "qa1", "qa2", "qa3"]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def avqa_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("avqa"))
    cfg = tiny_avqa4_cfg()
    tree = media_tree.make_avqa_tree(root, VIDEOS, n_frames=3, img_size=80,
                                     wave_samples=2 * cfg.htsat.frontend.clip_samples - 300,
                                     n_q=8)
    return root, tree


def test_vocabs_and_questions_match_jax(avqa_tree, tmp_path):
    """build_vocabs over the train split, parse_question with its template,
    tokenize with unknown words (0) and past 14 words (cut)."""
    root, _ = avqa_tree
    train = os.path.join(root, "avqa-train.json")
    assert PD.build_vocabs(train) == JD.build_vocabs(train)
    assert PD.load_vocab(os.path.join(root, "ques_vocab.txt")) == JD.load_vocab(
        os.path.join(root, "ques_vocab.txt"))
    sample = {"question_content": "Is the <Object> louder than the <Object> in the video?",
              "templ_values": "['violin', 'piano']"}
    words = PD.parse_question(sample)
    assert words == JD.parse_question(sample) and words[2] == "violin" and words[-1] == "video"
    vocab = {w: i for i, w in enumerate(["<pad>", "is", "the", "violin", "video"])}
    long = ["is", "the", "violin", "xylophone"] * 5
    for ws in (words, long, [], ["unknown"]):
        got = PD.tokenize(ws, vocab)
        np.testing.assert_array_equal(got, JD.tokenize(ws, vocab))
        assert got.dtype == np.int64 and got.shape == (PD.MAX_QST_LEN,)
    np.testing.assert_array_equal(PD.tokenize(long, vocab)[:5], [1, 2, 3, 0, 1])
    # the vocabularies built live where ques_vocab.txt is missing
    (tmp_path / "json").mkdir()
    (tmp_path / "json" / "avqa-train.json").write_text(open(train).read())
    ds = PD.AVQADataset(str(tmp_path), train)
    assert ds.ques_vocab == JD.AVQADataset(str(tmp_path), train).ques_vocab
    assert ds.ques_vocab[0] == "<pad>"


@pytest.mark.parametrize("seed", [0, 5])
def test_dataset_items_and_negative_draws_match_jax(avqa_tree, seed):
    """Items in order, one video a question: every array equal to JAX's, the
    negatives too, so both draw the same negative videos in sequence; with
    `with_nega=False` the draws still advance (the items after agree)."""
    root, t = avqa_tree
    cfg = tiny_avqa4_cfg()
    kw = dict(frame_dir=t["frames"], audio_dir=t["audio"], img_size=cfg.swin.img_size,
              num_frames=cfg.num_frames, segment_samples=cfg.htsat.frontend.clip_samples,
              seed=seed)
    split = os.path.join(root, "avqa-test.json")
    pds, jds = PD.AVQADataset(root, split, **kw), JD.AVQADataset(root, split, **kw)
    lean = PD.AVQADataset(root, split, with_nega=False, **kw)
    assert len(pds) == len(jds) == 8
    negas = []
    for i in range(8):
        got, ref, bare = pds[i], jds[i], lean[i]
        assert sorted(got) == sorted(ref) and "visual_nega" not in bare
        for k, v in ref.items():
            if isinstance(v, np.ndarray) or isinstance(v, np.integer):
                assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
                if k != "visual_nega":
                    np.testing.assert_array_equal(bare[k], v, err_msg=k)
            else:
                assert got[k] == v == bare[k]
        negas.append(got["visual_nega"])
    assert len({a.tobytes() for a in negas}) > 1


def test_question_type_accuracies_match_jax():
    types = ['["Audio", "Counting"]', "['Visual', 'Location']", '["Audio", "Counting"]',
             "not a list", "", "['Audio-Visual', 'Temporal']"]
    correct = [True, False, False, True, True, False]
    got, ref = PD.question_type_accuracies(types, correct), JD.question_type_accuracies(types,
                                                                                       correct)
    assert got == pytest.approx(ref, rel=1e-12)
    assert got["Unknown/Unknown"] == 100.0 and got["Audio/Counting"] == 50.0
    assert got["Avg"] == pytest.approx(50.0)


def test_synthetic_batch_matches_jax():
    got, ref = PD.synthetic_batch(2, img_size=32, seed=3), JD.synthetic_batch(2, img_size=32,
                                                                             seed=3)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    assert got["wave"].shape == (2, 10, 32000)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """Seeded tiny AVQA weights with nonzero adapter gates, as numpy and
    carried across by from_jax."""
    jcfg = tiny_avqa4_cfg()
    pcfg = port_avqa_cfg(jcfg)
    jp, js = (to_numpy(t) for t in PA.init_avqa_model(pcfg, seed=4, device="cpu"))
    jp = scramble_avqa(jp, seed=4)
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    return dict(jcfg=jcfg, pcfg=pcfg, jp=jp, js=js, pp=pp, ps=ps)


class Questions:
    """In-memory questions: float frames and wave, or uint8 frames and an
    int16 wave, with token ids, answers and types."""

    def __init__(self, n, cfg, wire=False, seed=0):
        rs = np.random.RandomState(seed)
        T, S = cfg.num_frames, cfg.swin.img_size
        wave = np.clip(0.3 * rs.randn(n, T, cfg.htsat.frontend.clip_samples), -1, 1)
        frames = rs.randint(0, 256, (n, T, S, S, 3), dtype=np.uint8)
        self.question = rs.randint(0, cfg.qst_vocab_size, (n, cfg.max_qst_len)).astype(np.int64)
        self.answer = rs.randint(0, cfg.ans_vocab_size, n).astype(np.int64)
        if wire:
            self.wave, self.visual_posi = (wave * 32767).astype(np.int16), frames
        else:
            self.wave = wave.astype(np.float32)
            self.visual_posi = rs.rand(n, T, S, S, 3).astype(np.float32)
        self.type = [f'["Audio", "Kind{i % 3}"]' for i in range(n)]

    def decoded(self):
        """The float wave and frames the wire formats stand for."""
        if self.wave.dtype != np.int16:
            return self.wave, self.visual_posi
        mean, std = np.asarray(IMAGENET_MEAN, np.float32), np.asarray(IMAGENET_STD, np.float32)
        return (self.wave.astype(np.float32) / 32767.0,
                ((self.visual_posi.astype(np.float32) - 255.0 * mean) / (255.0 * std)).astype(
                    np.float32))

    def __len__(self):
        return len(self.wave)

    def __getitem__(self, i):
        return {"wave": self.wave[i], "visual_posi": self.visual_posi[i],
                "question": self.question[i], "answer": self.answer[i], "type": self.type[i]}


def _engine(w, **kw):
    return AVQAInferenceEngine(w["pcfg"], w["pp"], w["ps"], batch_size=2, chunk=2, device="cpu",
                               compute_dtype=torch.float32, num_workers=2, **kw)


def _answers(eng, ds):
    out = list(eng.stream_answers(ds))
    return (np.concatenate([lg for lg, _, _ in out]), np.concatenate([a for _, a, _ in out]),
            [m for _, _, ms in out for m in ms], out)


def test_stream_answers_matches_the_jax_engine(weights):
    """5 questions at B=2, chunk 2: blocks of [[0, 1], [2, 3]] and [[4], []],
    the padding dropped, metas in dataset order; logits against the JAX
    engine's (float32, adapters folded on both sides)."""
    w = weights
    ds = Questions(5, w["pcfg"], seed=3)
    logits, answers, metas, blocks = _answers(_engine(w, gelu="exact"), ds)
    assert logits.shape == (5, 42) and [len(m) for _, _, m in blocks] == [4, 1]
    np.testing.assert_array_equal(answers, logits.argmax(-1))
    assert metas == list(zip(ds.answer.tolist(), ds.type))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        jeng = JAVQAEngine(w["jcfg"], jax.tree_util.tree_map(jnp.asarray, w["jp"]),
                           jax.tree_util.tree_map(jnp.asarray, w["js"]), batch_size=2, chunk=2,
                           compute_dtype=jnp.float32, num_workers=2)
        ref = list(jeng.stream_answers(ds))
    np.testing.assert_allclose(logits, np.concatenate([lg for lg, _, _ in ref]), atol=ATOL,
                               rtol=RTOL)
    assert metas == [m for _, _, ms in ref for m in ms]


def test_wire_formats_match_the_float_inputs(weights):
    """int16 waves and uint8 frames dequantized on the way in give the logits
    of the float wave and frames they decode to."""
    w = weights
    wire = Questions(3, w["pcfg"], wire=True, seed=4)
    flt = Questions(3, w["pcfg"], seed=4)
    flt.wave, flt.visual_posi = wire.decoded()
    eng = _engine(w)
    got, _, metas, _ = _answers(eng, wire)
    ref, _, _, _ = _answers(eng, flt)
    assert metas == list(zip(wire.answer.tolist(), wire.type))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_engine_folds_every_adapter_and_stages_the_questions(weights, monkeypatch):
    w = weights
    eng = AVQAInferenceEngine(w["pcfg"], w["pp"], w["ps"], device="cpu")
    assert (eng.B, eng.chunk) == (4, 4) and eng.gelu == "tanh"
    assert eng.params["fc_ans"]["kernel"].dtype == torch.bfloat16
    folded = [ap for k in eng.params["adapters"] for ap in eng.params["adapters"][k]]
    assert folded and not any({"bn1", "bn2", "gate"} & set(ap) for ap in folded)
    ds = Questions(3, w["pcfg"], seed=5)
    arrays, ids = next(_engine(w)._chunk_batches(ds))
    assert sorted(arrays) == ["question", "visual_posi", "wave"]
    assert arrays["question"].dtype == np.int64 and arrays["question"].shape == (2, 2, 14)
    np.testing.assert_array_equal(arrays["question"][1, 1], ds.question[2])
    assert ids == [list(zip(ds.answer[:2].tolist(), ds.type[:2])),
                   [(int(ds.answer[2]), ds.type[2])]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AVQAInferenceEngine(w["pcfg"], w["pp"], w["ps"])


# ---------------------------------------------------------------------------
# the converters and the tool
# ---------------------------------------------------------------------------

def _narrow(shape, jcfg):
    """A census head shape at the tiny widths: the embedding and the audio
    feature narrowed, the match classifier's 512/256/128 and the
    vocabularies kept."""
    d, f = jcfg.embed_dim, jcfg.htsat.num_features
    m = {1536: d, 3072: 2 * d, 4608: 3 * d, 6144: 4 * d, 768: f}
    return tuple(m.get(s, s) for s in shape)


def fake_avqa_sd(jcfg, grounding=False):
    """An AVQA_Fusion_Net (or, with `grounding`, AVQA_AVatt_Grounding) state
    dict at tiny tower widths: the towers of `fake_torch_sd`; for the
    fusion net its adapters as AVQA has them (four channel groups, no BN,
    no gate on the audio ones); the census's heads narrowed, from
    refgold_common.synth, dead keys of the ignore patterns included."""
    base = fake_torch_sd(jcfg)
    sd = {k: v for k, v in base.items() if k.startswith(("swin.", "htsat."))}
    census = "census_avqa_grounding.json" if grounding else "census_avqa_fusion.json"
    with open(GOLD / census) as f:
        spec = json.load(f)
    for k, s in spec.items():
        if not k.startswith(("swin.", "htsat.", "audio_adapter", "vis_adapter")):
            sd[k] = synth(k, _narrow(s["shape"], jcfg))
    if grounding:
        return sd
    g, r = jcfg.adapter.num_conv_group, jcfg.adapter.reduction_factor
    for k, v in base.items():
        if not k.startswith(("audio_adapter", "vis_adapter")) or ".bn" in k:
            continue
        if k.startswith("audio_adapter") and k.endswith(".gate"):
            continue
        C = v.shape[0] if "up_sampler" in k else None
        if k.endswith("down_sampler.weight"):
            v = synth(k, (v.shape[0], v.shape[0] * r // g, 1, 1))
        elif k.endswith("up_sampler.weight"):
            v = synth(k, (C, C // r // g, 1, 1))
        sd[k] = v
    return sd


def _convert(mod, sd, jcfg, grounding=False):
    tsd = mod.track(dict(sd))
    if grounding:
        tree = mod.convert_avqa_grounding(tsd)
        ignored = mod.AVQA_GROUNDING_CKPT_IGNORED_PATTERNS
    else:
        tree = mod.convert_avqa_fusion(tsd, len(ave_adapter_dims(jcfg.swin, jcfg.htsat)),
                                       jcfg.adapter.num_conv_group)
        ignored = mod.AVQA_CKPT_IGNORED_PATTERNS
    return tree, mod.census_report(tsd, ignored)


@pytest.mark.parametrize("grounding", [False, True], ids=["fusion", "grounding"])
def test_tiny_converters_equal_jax(grounding):
    """Leaf for leaf and report for report; the tree goes through from_jax
    and the port's forward takes it."""
    jcfg = tiny_avqa4_cfg()
    sd = fake_avqa_sd(jcfg, grounding)
    (pp, ps), prep = _convert(PTC, sd, jcfg, grounding)
    (jp, js), jrep = _convert(JTC, sd, jcfg, grounding)
    assert_trees_equal(pp, jp, "params")
    assert_trees_equal(ps, js, "state")
    assert prep == jrep and not prep["unexplained"]
    assert sorted(prep["consumed"] + prep["ignored"]) == sorted(sd)
    if not grounding:
        assert any(k.startswith("fc_a1_pure") for k in prep["ignored"])
        assert any(k.startswith("norm3") for k in prep["ignored"])
    pcfg = port_avqa_cfg(jcfg)
    tp, ts = from_jax(pp, ps, pcfg, device="cpu", grounding=grounding)
    rs = np.random.RandomState(6)
    T, S = jcfg.num_frames, jcfg.swin.img_size
    wave = (0.3 * rs.randn(1, T, jcfg.htsat.frontend.clip_samples)).astype(np.float32)
    with torch.inference_mode():
        if grounding:
            out = PG.forward(tp, ts, wave, rs.rand(1, 2, S, S, 3), pcfg, device="cpu")
        else:
            out = PA.forward(tp, ts, wave, rs.rand(1, T, S, S, 3), None,
                             rs.randint(0, 93, (1, 14)), pcfg, device="cpu")["out_qa"]
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("grounding", [False, True], ids=["fusion", "grounding"])
def test_full_width_avqa_censuses(grounding):
    """The AVQA checkpoints' censuses: both converters give the same tree and
    the same report, no key is unexplained, and `from_jax` takes the tree
    on the meta device at AVQAModelConfig(). JAX's tree is kept as a digest
    only, so one full-width tree is in memory at a time."""
    name = "census_avqa_grounding.json" if grounding else "census_avqa_fusion.json"
    sd = census_sd(name)
    assert len(sd) == (687 if grounding else 1996)
    cfg = AVQAModelConfig()
    jtsd = JTC.track(dict(sd))
    jtree = JTC.convert_avqa_grounding(jtsd) if grounding else JTC.convert_avqa_fusion(jtsd)
    jax_digest = digest(jtree)
    del jtree
    jrep = JTC.census_report(jtsd, JTC.AVQA_GROUNDING_CKPT_IGNORED_PATTERNS if grounding
                             else JTC.AVQA_CKPT_IGNORED_PATTERNS)
    (pp, ps), prep = _convert(PTC, sd, cfg, grounding)
    assert digest((pp, ps)) == list(jax_digest)
    assert prep == jrep and not prep["unexplained"]
    tp, _ = from_jax(pp, ps, cfg, device="meta", grounding=grounding)
    assert tp["fc_a1"]["kernel"].shape == (768, 1536)
    if not grounding:
        assert tp["adapters"]["a_p1"][0]["down"]["kernel"].shape == (4, 24, 3)
        assert tp["question_encoder"]["lstm"]["wh"].shape == (1536, 6144)
        assert "gate" not in tp["adapters"]["a_p1"][0] and "gate" in tp["adapters"]["v_p1"][0]


def _save_sd(sd, path):
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, str(path))
    return str(path)


@pytest.mark.parametrize("task", ["avqa", "avqa_grounding"])
def test_import_eval_avqa(task, tmp_path, capsys):
    """Exit 0 with the census, the shape audit and --save (a bundle the JAX
    package reads as it reads its own of JAX's converted tree: both drop the
    adapters' empty states); 2 on an unexplained key (0 with
    --lax); 3 on a misshapen leaf."""
    grounding = task == "avqa_grounding"
    jcfg = tiny_avqa4_cfg()
    cfg = port_avqa_cfg(jcfg)
    sd = fake_avqa_sd(jcfg, grounding)
    pt = _save_sd(sd, tmp_path / "ckpt.pt")
    out = tmp_path / "converted.npz"
    assert import_eval.main(["--task", task, "--ckpt", pt, "--census-only", "--save",
                             str(out)], cfg=cfg) is None
    text = capsys.readouterr().out
    assert "0 UNEXPLAINED" in text and "shape audit: OK" in text
    (jp, js), _ = _convert(JTC, sd, jcfg, grounding)
    JCK.save_params(str(tmp_path / "jax.npz"), {"params": jp, "state": js})
    bundle = JCK.load_params(str(out))
    assert sorted(bundle) == ["params", "state"]
    assert_trees_equal(bundle, JCK.load_params(str(tmp_path / "jax.npz")))

    extra = _save_sd({**sd, "mystery.weight": np.zeros(3, np.float32)}, tmp_path / "x.pt")
    with pytest.raises(SystemExit) as e:
        import_eval.main(["--task", task, "--ckpt", extra, "--census-only"], cfg=cfg)
    assert e.value.code == 2
    assert import_eval.main(["--task", task, "--ckpt", extra, "--lax"], cfg=cfg) is None
    bad = _save_sd({**sd, "fc3.weight": np.zeros((128, 7), np.float32)}, tmp_path / "bad.pt")
    with pytest.raises(SystemExit) as e:
        import_eval.main(["--task", task, "--ckpt", bad], cfg=cfg)
    assert e.value.code == 3
