"""The port's pretrain text and data pieces (dg_sct_tpu_torch: ops.bpe and its
vocab asset, models.roberta, models.clap_text, models.feature_fusion,
data.vggsound, utils.checkpoint.restore_matching, train.optim's global-norm
clip) against the JAX package on the same inputs and weights, float32 with
JAX at matmul precision "highest".

Tolerances: token ids exact on the AVE, LLP and VGGSound-style class names
(plain ASCII, where `ftfy`, which the JAX tokenizer runs when it imports,
changes nothing); RoBERTa, the CLAP text features and the feature fusion at
atol 1e-5 / rtol 1e-4 (float32 sums over a few layers); the dataset's items
and restore_matching's trees exact; the clipped gradients at rtol 1e-6.

The CLAP tests force JAX onto its byte-level tokenizer by making
`transformers` unimportable (the port has only that tokenizer); their
RoBERTa is an HF-format state dict of 2 layers at width 48 from a seed.
"""
import filecmp
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dg_sct_tpu.data import vggsound as JV
from dg_sct_tpu.models import clap_text as JCT
from dg_sct_tpu.models import feature_fusion as JF
from dg_sct_tpu.models import roberta as JR
from dg_sct_tpu.ops import bpe as JBPE
from dg_sct_tpu.utils import checkpoint as JCK
from dg_sct_tpu_torch.data import avvp as PAV
from dg_sct_tpu_torch.data import vggsound as PV
from dg_sct_tpu_torch.models import clap_text as PCT
from dg_sct_tpu_torch.models import feature_fusion as PF
from dg_sct_tpu_torch.models import roberta as PR
from dg_sct_tpu_torch.ops import bpe as PBPE
from dg_sct_tpu_torch.ops.basic import Init
from dg_sct_tpu_torch.train.optim import clip_by_global_norm
from dg_sct_tpu_torch.utils import checkpoint as PCK
from media_tree import make_vggsound_tree
from test_torch_avs import close
from torch_port_helpers import to_numpy, to_torch

S_ATOL, S_RTOL = 1e-5, 1e-4

AVE_CLASSES = [
    "Church bell", "Male speech, man speaking", "Bark", "Fixed-wing aircraft, airplane",
    "Race car, auto racing", "Female speech, woman speaking", "Helicopter", "Violin, fiddle",
    "Flute", "Ukulele", "Frying (food)", "Truck", "Shofar", "Motorcycle", "Acoustic guitar",
    "Train horn", "Clock", "Banjo", "Goat", "Baby cry, infant cry", "Bus", "Chainsaw", "Cat",
    "Horse", "Toilet flush", "Rodents, rats, mice", "Accordion", "Mandolin"]
VGGSOUND_STYLE = ["playing acoustic guitar", "dog barking", "people whistling",
                  "baby babbling", "church bell ringing", "race car, auto racing",
                  "people eating crisps", "lions roaring", "chicken crowing", "skateboarding",
                  "playing electric guitar", "cattle, bovinae cowbell", "it's a bird's call",
                  "engine accelerating, revving, vroom", "playing tabla  ", "mynah bird singing"]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the CLIP tokenizer
# ---------------------------------------------------------------------------

def test_vocab_asset_is_the_ports_own_copy():
    assert "dg_sct_tpu_torch" in PBPE.DEFAULT_BPE_PATH
    assert "dg_sct_tpu_torch" not in JBPE.DEFAULT_BPE_PATH
    assert filecmp.cmp(PBPE.DEFAULT_BPE_PATH, JBPE.DEFAULT_BPE_PATH, shallow=False)


@pytest.mark.parametrize("names", [AVE_CLASSES, list(PAV.CATEGORIES), VGGSOUND_STYLE],
                         ids=["AVE", "LLP", "VGGSound"])
def test_tokenizer_matches_jax(names):
    prompts = [f"a photo of a {n.replace('_', ' ')}." for n in names]
    np.testing.assert_array_equal(PBPE.tokenize(prompts), JBPE.tokenize(prompts))
    assert PBPE.tokenize(prompts).dtype == np.int32
    for n in names:
        assert PBPE.get_tokenizer().encode(n) == JBPE.get_tokenizer().encode(n)


def test_tokenize_frames_and_cuts():
    long = " ".join(["word"] * 100)
    ids = PBPE.tokenize(["", long])
    sot, eot = 49406, 49407
    assert ids.shape == (2, 77)
    assert list(ids[0, :3]) == [sot, eot, 0]
    assert ids[1, 0] == sot and ids[1, 76] == eot
    np.testing.assert_array_equal(ids, JBPE.tokenize(["", long]))


# ---------------------------------------------------------------------------
# RoBERTa and the CLAP text branch
# ---------------------------------------------------------------------------

def roberta_state(seed=0, hidden=48, layers=2, inter=96, vocab=300, max_pos=100):
    """A seeded HF-format RobertaModel state dict (numpy, (out, in)
    weights), with CLAP's text_projection and an unused text_transform, all
    under CLAP's prefixes."""
    rs = np.random.RandomState(seed)
    w = lambda *s: (0.2 * rs.randn(*s)).astype(np.float32)
    sd = {"embeddings.word_embeddings.weight": w(vocab, hidden),
          "embeddings.position_embeddings.weight": w(max_pos, hidden),
          "embeddings.token_type_embeddings.weight": w(1, hidden)}
    lin = lambda name, o, i: sd.update({f"{name}.weight": w(o, i), f"{name}.bias": w(o)})
    ln = lambda name, n: sd.update({f"{name}.weight": 1.0 + w(n), f"{name}.bias": w(n)})
    ln("embeddings.LayerNorm", hidden)
    lin("pooler.dense", hidden, hidden)
    for i in range(layers):
        b = f"encoder.layer.{i}"
        for n in ("attention.self.query", "attention.self.key", "attention.self.value",
                  "attention.output.dense"):
            lin(f"{b}.{n}", hidden, hidden)
        ln(f"{b}.attention.output.LayerNorm", hidden)
        lin(f"{b}.intermediate.dense", inter, hidden)
        lin(f"{b}.output.dense", hidden, inter)
        ln(f"{b}.output.LayerNorm", hidden)
    state = {f"text_branch.{k}": v for k, v in sd.items()}
    state.update({"text_projection.0.weight": w(32, hidden), "text_projection.0.bias": w(32),
                  "text_projection.2.weight": w(32, 32), "text_projection.2.bias": w(32),
                  "text_transform.sequential.0.weight": w(32, 32)})
    return state


@pytest.fixture
def fallback_tokenizer(monkeypatch):
    """`transformers` unimportable: JAX's `_tokenize` takes its fallback."""
    monkeypatch.setitem(sys.modules, "transformers", None)


def test_roberta_matches_jax(fallback_tokenizer):
    state = roberta_state()
    branch, transform, proj = PCT.split_clap_text_state(state)
    assert (len(branch), len(transform), len(proj)) == (39, 1, 4)
    texts = [PCT.PROMPT + n for n in ("dog", "Violin, fiddle", "background")]
    ids, mask = PCT.tokenize(texts)
    jids, jmask = JCT._tokenize(texts, JR.VOCAB)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    jp = JR.roberta_from_torch(branch)
    ref_h, ref_pool = JR.roberta_encode(jp, jnp.asarray(ids, jnp.int32),
                                        jnp.asarray(mask, jnp.int32))
    pp = PR.roberta_from_torch(branch)
    got_h, got_pool = PR.roberta_encode(pp, ids, mask)
    close(got_h, ref_h, S_ATOL, S_RTOL)
    close(got_pool, ref_pool, S_ATOL, S_RTOL)
    close(PR.text_projection(PR.projection_from_torch(proj), got_pool),
          JR.text_projection(JR.projection_from_torch(proj), ref_pool), S_ATOL, S_RTOL)
    assert set(pp["layers"][0]["q"]) == {"kernel", "bias"}   # one layout


@pytest.mark.parametrize("weak", [True, False], ids=["weak", "background"])
def test_clap_text_features_match_jax(fallback_tokenizer, weak):
    state = roberta_state(seed=1)
    names = ["dog", "cat", "Frying_(food)"]
    ref = JCT.compute_clap_text_features(names, weak=weak, clap_state_dict=state)
    got = PCT.compute_clap_text_features(names, weak=weak, clap_state_dict=state, device="cpu")
    assert got.shape == (len(names) + (0 if weak else 1), 32) and got.dtype == torch.float32
    close(got, ref, S_ATOL, S_RTOL)


def test_clap_text_features_seeded_init():
    """Without a state dict: RoBERTa-base and the 768 -> 512 -> 512
    projection from the seed; deterministic; weak=False appends one row."""
    feats = PCT.compute_clap_text_features(["dog", "cat"], device="cpu")
    assert feats.shape == (2, 512) and torch.isfinite(feats).all()
    again = PCT.compute_clap_text_features(["dog", "cat"], weak=False, device="cpu")
    assert again.shape == (3, 512)
    assert torch.equal(again[:2], feats)
    assert not torch.equal(PCT.compute_clap_text_features(["dog", "cat"], seed=1, device="cpu"),
                           feats)


# ---------------------------------------------------------------------------
# feature fusion
# ---------------------------------------------------------------------------

def _fusion_params(init_fn, channels, seed):
    """A port init as numpy with seeded BN scales, biases and running stats."""
    p, s = init_fn(Init(torch.Generator().manual_seed(seed), "cpu"), channels=channels, r=4)
    p, s = to_numpy(p), to_numpy(s)
    rs = np.random.RandomState(seed)
    for name in p:
        for bn in ("bn1", "bn2"):
            n = p[name][bn]["scale"].shape[0]
            p[name][bn] = {"scale": (1 + 0.3 * rs.randn(n)).astype(np.float32),
                           "bias": (0.2 * rs.randn(n)).astype(np.float32)}
            s[name][bn] = {"mean": (0.1 * rs.randn(n)).astype(np.float32),
                           "var": (0.5 + rs.rand(n)).astype(np.float32),
                           "count": s[name][bn]["count"]}
    return p, s


@pytest.mark.parametrize("kind", ["aff", "iaff"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shape", [(2, 5, 16), (1, 5, 16), (2, 3, 4, 16)],
                         ids=["1d", "batch1", "2d"])
def test_feature_fusion_matches_jax(kind, train, shape):
    init_p = PF.init_aff if kind == "aff" else PF.init_iaff
    fn_p, fn_j = getattr(PF, kind), getattr(JF, kind)
    jp, js = _fusion_params(init_p, shape[-1], seed=len(shape) + train)
    rs = np.random.RandomState(7)
    x, res = rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)
    ref, ref_s = fn_j(jp, js, jnp.asarray(x), jnp.asarray(res), train=train)
    got, got_s = fn_p(to_torch(jp), to_torch(js), torch.from_numpy(x), torch.from_numpy(res),
                      train=train)
    close(got, ref, S_ATOL, S_RTOL)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got_s)[0],
                                 jax.tree_util.tree_flatten_with_path(ref_s)[0]):
        close(a, b, S_ATOL, S_RTOL, msg=str(path))
    assert torch.equal(PF.daf(torch.from_numpy(x), torch.from_numpy(res)),
                       torch.from_numpy(x + res))


def test_iaff_round_two_reuses_global_att():
    """global_att2 is never applied: changing it changes nothing."""
    p, s = _fusion_params(PF.init_iaff, 16, seed=3)
    x = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(0))
    base = PF.iaff(to_torch(p), to_torch(s), x, x.flip(0))[0]
    p["global_att2"]["fc1"]["kernel"] = p["global_att2"]["fc1"]["kernel"] + 1.0
    assert torch.equal(PF.iaff(to_torch(p), to_torch(s), x, x.flip(0))[0], base)


# ---------------------------------------------------------------------------
# VGGSound data, restore_matching, the global-norm clip
# ---------------------------------------------------------------------------

CATS = ["dog barking", "playing violin", "people whistling"]


@pytest.mark.parametrize("ids", [["000123", "012345", "004567", "000009", "000077", "314159"],
                                 ["000123", "abcdefghijk", "004567", "-x_y", "000077", "314159"]],
                         ids=["numeric", "mixed"])
def test_vggsound_dataset_matches_jax(tmp_path, ids):
    """Items, lengths and K-shot subsets against JAX's pandas parse: all-numeric
    ids with leading zeros (pandas reads integers, and zfill(6) puts the
    zeros back) and mixed ones (strings as written)."""
    tree = make_vggsound_tree(str(tmp_path), ids, CATS, n_frames=3, img_size=32,
                              wave_samples=4000)
    for split, shot in (("train", 0), ("train", 1), ("test", 0)):
        kw = dict(frame_dir=tree["frames"], audio_dir=tree["audio"], img_size=32,
                  num_frames=4, segment_samples=1000, shot=shot)
        ref = JV.VGGSoundAVELDataset(tree["meta"], split, **kw)
        got = PV.VGGSoundAVELDataset(tree["meta"], split, **kw)
        assert len(got) == len(ref) > 0 and got.num_classes == ref.num_classes == len(CATS)
        for i in range(len(ref)):
            a, b = got[i], ref[i]
            assert set(a) == set(b) == {"image", "wave", "GT"}
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{split} {i} {k}")
    gt = np.stack([PV.VGGSoundAVELDataset(tree["meta"], "train", frame_dir=tree["frames"],
                                          audio_dir=tree["audio"], img_size=32, num_frames=10,
                                          segment_samples=400)[i]["GT"] for i in range(3)])
    gt[1, :, :-1] = 0
    gt[1, :, -1] = 1
    np.testing.assert_array_equal(PV.weak_labels(gt), JV.weak_labels(gt))
    assert PV.load_categories(f"{tree['meta']}/VggsoundAVEL40kCategories.txt") == CATS


def test_restore_matching_matches_jax():
    template = {"a": np.zeros((2, 3), np.float32), "b": [np.ones(4, np.float32),
                                                         np.zeros((2,), np.float32)],
                "c": {"d": np.zeros(5, np.float32)}}
    loaded = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": [np.full(3, 7.0, np.float32), np.full(2, 8.0, np.float32)],
              "c": {"d": np.full(5, 9.0, np.float32), "e": np.ones(1, np.float32)}}
    ref, ref_skipped = JCK.restore_matching(template, loaded)
    got, skipped = PCK.restore_matching(to_torch(template), loaded)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(ref)[0]):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=str(path))
    assert set(skipped) == set(ref_skipped) == {"b/0", "c/e"}
    assert isinstance(got["b"], list) and got["a"].dtype == torch.float32


@pytest.mark.parametrize("scale", [0.01, 100.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_optax(scale):
    rs = np.random.RandomState(0)
    grads = [(scale * rs.randn(*s)).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    ref = optax.clip_by_global_norm(1.0).update(grads, optax.EmptyState())[0]
    got = clip_by_global_norm([torch.from_numpy(g) for g in grads], 1.0)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    if scale == 0.01:
        assert all(torch.equal(a, torch.from_numpy(g)) for a, g in zip(got, grads))
