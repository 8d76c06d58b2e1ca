"""HF `transformers` import (dg_sct_tpu_torch.utils.hf_convert and the two
key renames of utils.torch_convert) against the JAX package's on tiny
random `transformers` models (skipped without `transformers`), the port's
Swin-V2, CLIP and PVT-v2 towers against HF's own outputs, and
`flops_estimate` and `trace`. Tolerances: converted trees and renamed state dicts
exactly; Swin-V2 tokens atol 3e-3, rtol 1e-2, CLIP features atol 1e-4,
rtol 1e-3 and PVT maps atol 2e-4, rtol 2e-3 (those of
tests/test_third_party_parity.py); the FLOP count exactly. The spans:
tests/test_torch_tracing.py."""
import numpy as np
import jax
import pytest
import torch

from dg_sct_tpu.utils import hf_convert as JHF
from dg_sct_tpu.utils import torch_convert as JTC
from dg_sct_tpu_torch.configs import CLIPConfig, SwinV2Config
from dg_sct_tpu_torch.models import clip as PC
from dg_sct_tpu_torch.models import pvt as PP
from dg_sct_tpu_torch.models import swinv2 as PS
from dg_sct_tpu_torch.ops.basic import seeded_init
from dg_sct_tpu_torch.utils import hf_convert as PHF
from dg_sct_tpu_torch.utils import profiling as PR
from dg_sct_tpu_torch.utils import torch_convert as PTC
from dg_sct_tpu_torch.utils.tree import tree_paths
from dg_sct_tpu_torch.weights import from_jax_tree

META = seeded_init(0, "meta")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def same_tree(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert [k for k, _ in pa] == [k for k, _ in pb]
    for (k, x), (_, y) in zip(pa, pb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(k))


def same_state(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def hf_swinv2():
    tr = pytest.importorskip("transformers")
    hcfg = tr.Swinv2Config(image_size=64, patch_size=4, num_channels=3, embed_dim=16,
                           depths=[1, 1, 2, 1], num_heads=[2, 2, 2, 2], window_size=4,
                           drop_path_rate=0.0, hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0, use_absolute_embeddings=False)
    torch.manual_seed(0)
    hf = tr.Swinv2Model(hcfg).eval()
    cfg = SwinV2Config(img_size=64, patch_size=4, embed_dim=16, depths=(1, 1, 2, 1),
                       num_heads=(2, 2, 2, 2), window_size=4, drop_path_rate=0.0,
                       pretrained_window_sizes=(0, 0, 0, 0))
    return hf, cfg


@pytest.mark.parametrize("given", ["model", "tensors", "numpy"])
def test_swinv2_from_transformers(hf_swinv2, given):
    """The same tree as JAX's converter from a model, its tensor state dict
    or a numpy one; carried onto the port's tree."""
    hf, cfg = hf_swinv2
    sd = hf.state_dict()
    src = {"model": hf, "tensors": sd,
           "numpy": {k: v.numpy() for k, v in sd.items()}}[given]
    tree = PHF.swinv2_from_transformers(src, cfg)
    same_tree(tree, jax.tree_util.tree_map(np.asarray, JHF.swinv2_from_transformers(hf, cfg)))
    from_jax_tree(tree, PS.init_swinv2(META, cfg), device="cpu")


@pytest.mark.parametrize("kernels", [False, True])
def test_swinv2_tower_against_transformers(hf_swinv2, kernels):
    hf, cfg = hf_swinv2
    params = from_jax_tree(PHF.swinv2_from_transformers(hf, cfg), PS.init_swinv2(META, cfg),
                           device="cpu")
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        ref = hf(nchw(x)).last_hidden_state.numpy()
        got = PS.forward_features(params, torch.from_numpy(x), cfg, kernels=kernels).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-3, rtol=1e-2)


def test_hf_swinv2_to_timm_keys(hf_swinv2):
    """The rename gives JAX's keys and arrays, and `convert_swinv2` over it
    the tree of the direct path."""
    hf, cfg = hf_swinv2
    renamed = PTC.hf_swinv2_to_timm_keys(hf.state_dict())
    same_state(renamed, JTC.hf_swinv2_to_timm_keys(hf.state_dict()))
    same_tree(PTC.convert_swinv2(renamed, depths=cfg.depths),
              PHF.swinv2_from_transformers(hf, cfg))


def test_clip_from_transformers_and_towers():
    tr = pytest.importorskip("transformers")
    width, layers, heads, embed, patch, img = 32, 2, 2, 16, 8, 32
    twidth, tlayers, theads, vocab, ctx = 24, 2, 2, 49408, 77
    hcfg = tr.CLIPConfig(
        projection_dim=embed,
        vision_config=dict(hidden_size=width, intermediate_size=4 * width,
                           num_hidden_layers=layers, num_attention_heads=heads,
                           image_size=img, patch_size=patch, hidden_act="quick_gelu",
                           attention_dropout=0.0),
        text_config=dict(hidden_size=twidth, intermediate_size=4 * twidth,
                         num_hidden_layers=tlayers, num_attention_heads=theads,
                         vocab_size=vocab, max_position_embeddings=ctx,
                         hidden_act="quick_gelu", attention_dropout=0.0))
    torch.manual_seed(1)
    hf = tr.CLIPModel(hcfg).eval()
    cfg = CLIPConfig(image_size=img, vision_patch=patch, vision_width=width,
                     vision_layers=layers, vision_heads=heads, embed_dim=embed,
                     context_length=ctx, text_width=twidth, text_layers=tlayers,
                     text_heads=theads, vocab_size=vocab)
    vp, tp = PHF.clip_from_transformers(hf.state_dict(), cfg)
    jv, jt = JHF.clip_from_transformers(hf, cfg)
    same_tree(vp, jax.tree_util.tree_map(np.asarray, jv))
    same_tree(tp, jax.tree_util.tree_map(np.asarray, jt))
    ref_t = PC.init_text(META, cfg)
    vp = from_jax_tree(vp, PC.init_visual(META, cfg), device="cpu")
    tp = from_jax_tree({k: v for k, v in tp.items() if k in ref_t}, ref_t, device="cpu")
    x = np.random.RandomState(0).randn(2, img, img, 3).astype(np.float32)
    tok = np.zeros((2, ctx), np.int64)
    tok[0, :6] = [49406, 10, 20, 30, 40, 49407]
    tok[1, :3] = [49406, 11, 49407]
    with torch.no_grad():
        ref_v = hf.get_image_features(nchw(x)).numpy()
        ref_tx = hf.get_text_features(input_ids=torch.from_numpy(tok)).numpy()
        got_v = PC.visual_forward(vp, torch.from_numpy(x), cfg).numpy()
        got_tx = PC.encode_text(tp, tok, cfg).numpy()
    np.testing.assert_allclose(got_v, ref_v, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got_tx, ref_tx, atol=1e-4, rtol=1e-3)


def test_pvt_v2_from_transformers_and_tower():
    tr = pytest.importorskip("transformers")
    depths = [1, 1, 1, 1]
    hcfg = tr.PvtV2Config(depths=depths, hidden_sizes=[32, 64, 160, 256],
                          num_attention_heads=[1, 2, 5, 8], sr_ratios=[8, 4, 2, 1],
                          mlp_ratios=[8, 8, 4, 4], image_size=64, drop_path_rate=0.0,
                          hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = tr.PvtV2Model(hcfg).eval()
    cfg = PP.PVTv2Config(img_size=64, embed_dims=(32, 64, 160, 256), depths=tuple(depths),
                         num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4),
                         sr_ratios=(8, 4, 2, 1), drop_path_rate=0.0)
    tree = PHF.pvt_v2_from_transformers(hf, depths)
    same_tree(tree, jax.tree_util.tree_map(np.asarray, JHF.pvt_v2_from_transformers(hf, depths)))
    params = from_jax_tree(tree, PP.init_pvt_v2(META, cfg), device="cpu")
    img = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        ref = hf(nchw(img), output_hidden_states=True).hidden_states
        got = PP.forward_features(params, torch.from_numpy(img), cfg)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy().transpose(0, 2, 3, 1), atol=2e-4,
                                   rtol=2e-3)


def test_hf_clap_audio_to_htsat_keys():
    tr = pytest.importorskip("transformers")
    from transformers.models.clap.modeling_clap import ClapAudioModel

    hcfg = tr.ClapAudioConfig(spec_size=128, num_mel_bins=32, window_size=2,
                              patch_embeds_hidden_size=16, depths=[1, 1, 2, 1],
                              num_attention_heads=[2, 2, 2, 2], drop_path_rate=0.0,
                              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                              enable_fusion=False)
    torch.manual_seed(7)
    hf = ClapAudioModel(hcfg).eval()
    hf.audio_encoder.batch_norm.running_mean.normal_(0, 0.3)
    renamed = PTC.hf_clap_audio_to_htsat_keys(hf.state_dict())
    same_state(renamed, JTC.hf_clap_audio_to_htsat_keys(hf.state_dict()))
    p, s = PTC.convert_htsat(renamed, depths=(1, 1, 2, 1))
    jp, js = JTC.convert_htsat(JTC.hf_clap_audio_to_htsat_keys(hf.state_dict()),
                               depths=(1, 1, 2, 1))
    same_tree(p, jp)
    same_tree(s, js)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mnk", [(64, 48, 32), (7, 130, 9)])
def test_flops_estimate_of_a_gemm(mnk):
    """2 M N K for an (M, K) x (K, N) product, counted on the "meta" device
    (nothing computed; the arguments may start on the CPU)."""
    M, N, K = mnk
    seen = []

    def fn(a, b):
        seen.append(a.device.type)
        return a @ b

    est = PR.flops_estimate(fn, torch.randn(M, K), torch.randn(K, N))
    assert est["flops"] == 2 * M * N * K and seen == ["meta"]
    assert est["aten.mm"] == 2 * M * N * K


def test_flops_estimate_of_a_tree_and_a_convolution():
    """Tensors nested in parameter trees go to "meta" too; a convolution
    counts 2 * outputs * kernel volume * input channels."""
    from dg_sct_tpu_torch.ops.basic import conv2d

    params = {"kernel": torch.randn(3, 3, 4, 8), "bias": torch.zeros(8)}
    est = PR.flops_estimate(lambda p, x: conv2d(p, x, stride=2), params,
                            torch.randn(2, 10, 10, 4))
    assert est["flops"] == 2 * (2 * 5 * 5 * 8) * (3 * 3 * 4)


def test_trace_writes_a_chrome_trace(tmp_path):
    with PR.trace(str(tmp_path / "tr")) as prof:
        torch.randn(16, 16) @ torch.randn(16, 16)
    path = tmp_path / "tr" / "trace.json"
    assert path.stat().st_size > 0 and "traceEvents" in path.read_text()
    assert any("mm" in e.key for e in prof.key_averages())
