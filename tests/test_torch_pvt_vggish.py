"""PVT-v2 and VGGish (dg_sct_tpu_torch) against the JAX package on the same
seeded numpy inputs, JAX's weights carried across by
`weights.from_jax_tree`, float32, JAX at matmul precision "highest".
Tolerances: PVT maps atol 1e-4 (LN-normalized, |value| ~ 1); VGGish
log-mel examples atol 1e-4 (the port's numpy FFT against JAX's), the
embeddings within 1e-5 of their largest value, the quantized PCA
codes within one step; the converters' trees exactly."""
import json
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from dg_sct_tpu.models import pvt as JP
from dg_sct_tpu.models import vggish as JG
from dg_sct_tpu.utils import torch_convert as JTC
from dg_sct_tpu_torch.models import pvt as PP
from dg_sct_tpu_torch.models import vggish as PG
from dg_sct_tpu_torch.ops.basic import seeded_init
from dg_sct_tpu_torch.utils import torch_convert as PTC
from dg_sct_tpu_torch.utils.tree import tree_paths
from dg_sct_tpu_torch.weights import from_jax_tree
from torch_port_helpers import to_numpy

REPO = Path(__file__).resolve().parents[1]
PVT_ATOL = 1e-4
MEL_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def carried(jtree, ref):
    return from_jax_tree(to_numpy(jtree), ref, device="cpu")


def same_tree(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert [k for k, _ in pa] == [k for k, _ in pb]
    for (k, x), (_, y) in zip(pa, pb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(k))


# ---------------------------------------------------------------------------
# PVT-v2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["b0", "b2_li"])
def test_pvt_forward_features(preset):
    """Every stage's map at 64x64 (b2_li: the linear SRA's 7x7 adaptive
    pool over 16x16, 8x8, 4x4 and 2x2 grids, floor/ceil bins)."""
    jcfg = getattr(JP, f"pvt_v2_{preset}")(img_size=64)
    pcfg = getattr(PP, f"pvt_v2_{preset}")(img_size=64)
    assert pcfg == PP.PVTv2Config(**{k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__})
    # the port's seeded weights, every leaf nudged (LN affines off 1 and 0),
    # in JAX as numpy; JAX's own tree by shape (its initialiser is slow eager)
    rs = np.random.RandomState(0)
    ref = PP.init_pvt_v2(seeded_init(0, "meta"), pcfg)
    jp = jax.tree_util.tree_map(
        lambda a: (a.numpy() + 0.05 * rs.randn(*a.shape)).astype(np.float32),
        PP.init_pvt_v2(seeded_init(1, "cpu"), pcfg))
    shapes = jax.eval_shape(lambda k: JP.init_pvt_v2(k, jcfg), jax.random.PRNGKey(0))
    assert ([(k, tuple(v.shape)) for k, v in tree_paths(shapes)]
            == [(k, tuple(v.shape)) for k, v in tree_paths(ref)])
    pp = carried(jp, ref)
    x = rs.randn(2, 64, 64, 3).astype(np.float32)
    refs = jax.jit(lambda p, x: JP.forward_features(p, x, jcfg))(jp, x)
    gots = PP.forward_features(pp, torch.from_numpy(x), pcfg)
    assert [tuple(g.shape) for g in gots] == [(2, 16, 16, pcfg.embed_dims[0]),
                                              (2, 8, 8, pcfg.embed_dims[1]),
                                              (2, 4, 4, pcfg.embed_dims[2]),
                                              (2, 2, 2, pcfg.embed_dims[3])]
    for g, r in zip(gots, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=PVT_ATOL)


def test_pvt_train_draws_drop_path_from_the_generator():
    cfg = PP.pvt_v2_b0(img_size=32, drop_path_rate=0.5)
    p = PP.init_pvt_v2(seeded_init(0, "cpu"), cfg)
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    run = lambda s: PP.forward_features(p, x, cfg, train=True,
                                        gen=torch.Generator().manual_seed(s))[-1]
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    assert torch.equal(PP.forward_features(p, x, cfg, train=True)[-1],
                       PP.forward_features(p, x, cfg)[-1])


def census_zeros(name):
    census = json.loads((REPO / "tests" / "golden" / name).read_text())
    return {k: np.zeros(v["shape"], np.dtype(v["dtype"])) for k, v in census.items()}


def test_pvt_b5_from_the_census_on_meta():
    """The AVS checkpoint's PVT-v2-b5 keys through the port's and JAX's
    `convert_pvt_v2`: the same tree, every key read, carried onto the
    port's b5 tree on the "meta" device (shapes only) by `from_jax_tree`."""
    sd = PTC.track(census_zeros("census_avs_pvt_v2_b5.json"))
    tree = PTC.convert_pvt_v2(sd)
    assert sd.accessed == set(sd)
    same_tree(tree, JTC.convert_pvt_v2(census_zeros("census_avs_pvt_v2_b5.json")))
    ref = PP.init_pvt_v2(seeded_init(0, "meta"), PP.pvt_v2_b5())
    on_meta = from_jax_tree(tree, ref, device="meta")
    assert on_meta["stages"][2]["blocks"][39]["kv"]["kernel"].shape == (320, 640)
    assert on_meta["stages"][0]["blocks"][0]["sr"]["kernel"].device.type == "meta"
    shapes = jax.eval_shape(lambda k: JP.init_pvt_v2(k, JP.pvt_v2_b5()), jax.random.PRNGKey(0))
    assert ([(k, tuple(v.shape)) for k, v in tree_paths(shapes)]
            == [(k, tuple(v.shape)) for k, v in tree_paths(on_meta)])


# ---------------------------------------------------------------------------
# VGGish
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wave16k():
    rs = np.random.RandomState(2)
    t = np.arange(16000 * 3) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rs.randn(t.size)).astype(np.float32)


def test_waveform_to_examples(wave16k):
    ref = np.asarray(JG.waveform_to_examples(wave16k))
    got = PG.waveform_to_examples(wave16k)
    assert got.shape == ref.shape == (3, 96, 64, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=MEL_ATOL)
    np.testing.assert_array_equal(PG._mel_matrix(), JG._mel_matrix())
    assert PG.waveform_to_examples(np.zeros(100, np.float32)).shape == (0, 96, 64, 1)


@pytest.fixture(scope="module")
def vggish_params():
    jp = JG.init_vggish(jax.random.PRNGKey(3))
    jpca = JG.init_postprocessor(jax.random.PRNGKey(4))
    jpca = dict(jpca, pca_means=np.random.RandomState(5).randn(128).astype(np.float32) * 0.1)
    pp = carried(jp, PG.init_vggish(seeded_init(0, "meta")))
    ppca = carried(jpca, PG.init_postprocessor(seeded_init(0, "meta")))
    return jp, jpca, pp, ppca


def test_vggish_and_postprocess(wave16k, vggish_params):
    jp, jpca, pp, ppca = vggish_params
    ex = PG.waveform_to_examples(wave16k)
    ref = np.asarray(JG.vggish(jp, ex))
    got = PG.vggish(pp, torch.from_numpy(ex)).numpy()
    assert got.shape == (3, 128)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    # PCA on JAX's embeddings; 20x scale so the codes spread over 0..255
    emb = ref * 20.0
    raw_ref = np.asarray(JG.postprocess(jpca, emb, quantize=False))
    raw = PG.postprocess(ppca, torch.from_numpy(emb), quantize=False).numpy()
    np.testing.assert_allclose(raw, raw_ref, atol=1e-5 * np.abs(raw_ref).max(), rtol=0)
    q_ref = np.asarray(JG.postprocess(jpca, emb))
    q = PG.postprocess(ppca, torch.from_numpy(emb)).numpy()
    assert q.min() >= 0 and q.max() <= 255 and (q == np.round(q)).all()
    assert np.abs(q - q_ref).max() <= 1 and (q == q_ref).mean() > 0.99


def torchvggish_state(pn, pca):
    """torchvggish's VGG and Postprocessor state dicts holding the numpy
    trees (the inverse of the converters)."""
    sd = {}
    for i, c in zip((0, 3, 6, 8, 11, 13), pn["convs"]):
        sd[f"features.{i}.weight"] = np.ascontiguousarray(np.transpose(c["kernel"], (3, 2, 0, 1)))
        sd[f"features.{i}.bias"] = c["bias"]
    for i, n in zip((0, 2, 4), ("fc1", "fc2", "fc3")):
        sd[f"embeddings.{i}.weight"] = np.ascontiguousarray(pn[n]["kernel"].T)
        sd[f"embeddings.{i}.bias"] = pn[n]["bias"]
    return sd, {"pca_eigen_vectors": pca["pca_matrix"], "pca_means": pca["pca_means"][:, None]}


def test_convert_vggish_and_pca_against_jax(vggish_params):
    jp, jpca, _, _ = vggish_params
    sd, pca_sd = torchvggish_state(to_numpy(jp), to_numpy(jpca))
    tree, pca = PTC.convert_vggish(sd), PTC.convert_vggish_pca(pca_sd)
    same_tree(tree, JTC.convert_vggish(sd))
    same_tree(pca, JTC.convert_vggish_pca(pca_sd))
    same_tree(tree, to_numpy(jp))
    same_tree(pca, to_numpy(jpca))
    ref = PG.init_vggish(seeded_init(0, "meta"))
    carried_tree = from_jax_tree(tree, ref, device="cpu")
    assert carried_tree["fc1"]["kernel"].shape == (512 * 4 * 6, 4096)
