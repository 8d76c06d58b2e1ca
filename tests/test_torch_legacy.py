"""The dormant modules (dg_sct_tpu_torch: phm, the eight attention variants,
the five legacy AVE modules, the AST, ModifiedResNet, AVENet) against the
JAX package on the same seeded numpy inputs, JAX's weights carried across
by `weights.from_jax_tree` (non-array leaves such as head counts and
strides included), float32, JAX at matmul precision "highest". Tolerance:
atol 1e-5 times the reference's largest |value| (at least 1e-5), BN
running statistics likewise; the Kronecker products exactly."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.models import attentions as JA
from dg_sct_tpu.models import legacy as JL
from dg_sct_tpu.models import legacy_backbones as JLB
from dg_sct_tpu.models import phm as JPH
from dg_sct_tpu_torch.models import attentions as PA
from dg_sct_tpu_torch.models import legacy as PL
from dg_sct_tpu_torch.models import legacy_backbones as PLB
from dg_sct_tpu_torch.models import phm as PPH
from dg_sct_tpu_torch.ops.basic import seeded_init
from dg_sct_tpu_torch.utils.tree import tree_map, tree_paths
from dg_sct_tpu_torch.weights import from_jax_tree
from torch_port_helpers import to_numpy

REL = 1e-5

META = seeded_init(0, "meta")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def carry(jtree, port_init, *args, **kw):
    """JAX's tree onto the port's, built by `port_init(META, ...)`."""
    return from_jax_tree(to_numpy(jtree), port_init(META, *args, **kw), device="cpu")


def port_weights(jinit, port_init, *args, seed=1, **kw):
    """The port's seeded tree as numpy for JAX (non-array leaves kept),
    its structure held against JAX's initialiser by shape, and carried back
    by `from_jax_tree`; JAX's own initialisers of the backbones are slow
    eager."""
    out = port_init(seeded_init(seed, "cpu"), *args, **kw)
    jt = tree_map(lambda a: a.numpy() if torch.is_tensor(a) else a, out)
    shapes = jax.eval_shape(lambda k: jinit(k, *args, **kw), jax.random.PRNGKey(0))
    assert ([(k, np.shape(v)) for k, v in tree_paths(shapes)]
            == [(k, np.shape(v)) for k, v in tree_paths(jt)])
    ref = port_init(META, *args, **kw)
    if isinstance(out, tuple):  # (params, state)
        return tuple(jt), tuple(from_jax_tree(a, r, device="cpu") for a, r in zip(jt, ref))
    return jt, from_jax_tree(jt, ref, device="cpu")


def close(got, ref):
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            close(g, r)
        return
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            close(got[k], ref[k])
        return
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=max(REL * np.abs(ref).max(), REL), rtol=0)


def arr(rs, *shape, scale=1.0):
    return (scale * rs.randn(*shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# PHM
# ---------------------------------------------------------------------------

def test_kronecker_products_exact():
    rs = np.random.RandomState(0)
    a, b = arr(rs, 3, 2, 4), arr(rs, 3, 5, 3)
    got = PPH.kronecker_product(t(a), t(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JPH.kronecker_product(a, b)))
    np.testing.assert_allclose(got[1], np.kron(a[1], b[1]), rtol=1e-6)
    np.testing.assert_array_equal(PPH.kronecker_product_einsum_batched(t(a), t(b)).numpy(),
                                  np.asarray(JPH.kronecker_product_einsum_batched(a, b)))


@pytest.mark.parametrize("kw", [{}, {"factorized_phm": True, "phm_rank": 2},
                                {"factorized_phm_rule": True}, {"w_init": "glorot-normal"},
                                {"w_init": "glorot-uniform", "bias": False}],
                         ids=["plain", "factorized_w", "factorized_rule", "glorot_normal",
                              "glorot_uniform_nobias"])
def test_phm_linear(kw):
    jp = JPH.init_phm_linear(jax.random.PRNGKey(1), 12, 8, 4, phm_init_range=0.3, **kw)
    if "b" in jp:
        jp = dict(jp, b=arr(np.random.RandomState(2), 8))
    pp = carry(jp, PPH.init_phm_linear, 12, 8, 4, **kw)
    x = arr(np.random.RandomState(3), 2, 5, 12)
    close(PPH.phm_linear(pp, t(x)), JPH.phm_linear(jp, x))
    # against the materialized H = sum_i rule[i] (x) W[i]
    W = (np.einsum("ipr,irl->ipl", jp["W_left"], jp["W_right"]) if "W_left" in jp
         else np.asarray(jp["W"]))
    rule = (np.einsum("ijr,irk->ijk", jp["phm_rule_left"], jp["phm_rule_right"])
            if "phm_rule_left" in jp else np.asarray(jp["phm_rule"]))
    H = sum(np.kron(rule[i], W[i]) for i in range(4))
    close(PPH.phm_linear(pp, t(x)), x @ H + (np.asarray(jp["b"]) if "b" in jp else 0))


# ---------------------------------------------------------------------------
# attention variants
# ---------------------------------------------------------------------------

B, LQ, LK, D = 2, 3, 7, 16


@pytest.fixture(scope="module")
def qkv():
    rs = np.random.RandomState(4)
    mask = rs.rand(B, LQ, LK) < 0.3
    mask[..., 0] = False
    return arr(rs, B, LQ, D), arr(rs, B, LK, D), arr(rs, B, LK, D), mask


@pytest.mark.parametrize("masked", [False, True])
def test_scaled_and_dot_product(qkv, masked):
    q, k, v, mask = qkv
    m = mask if masked else None
    close(PA.scaled_dot_product_attention(t(q), t(k), t(v), None if m is None else t(m)),
          JA.scaled_dot_product_attention(q, k, v, m))
    close(PA.dot_product_attention(t(q), t(v)), JA.dot_product_attention(q, v))


def test_additive(qkv):
    q, k, v, _ = qkv
    jp = JA.init_additive(jax.random.PRNGKey(5), D)
    pp = carry(jp, PA.init_additive, D)
    close(PA.additive_attention(pp, t(q[:, :1]), t(k), t(v)),
          JA.additive_attention(jp, q[:, :1], k, v))


@pytest.mark.parametrize("smoothing", [True, False])
def test_location_aware(qkv, smoothing):
    q, _, v, _ = qkv
    jp = JA.init_location_aware(jax.random.PRNGKey(6), D, smoothing=smoothing)
    pp = carry(jp, PA.init_location_aware, D, smoothing=smoothing)
    last = np.random.RandomState(7).rand(B, LK).astype(np.float32)
    for la in (None, last):
        close(PA.location_aware_attention(pp, t(q[:, :1]), t(v), None if la is None else t(la)),
              JA.location_aware_attention(jp, q[:, :1], v, la))


def test_multi_head_location_aware(qkv):
    q, _, v, _ = qkv
    jp = JA.init_multi_head_location_aware(jax.random.PRNGKey(8), D, num_heads=4)
    pp = carry(jp, PA.init_multi_head_location_aware, D, num_heads=4)
    last = np.random.RandomState(9).rand(B, 4, LK).astype(np.float32)
    for la in (None, last):
        close(PA.multi_head_location_aware_attention(pp, t(q[:, :1]), t(v),
                                                     None if la is None else t(la)),
              JA.multi_head_location_aware_attention(jp, q[:, :1], v, la))


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head(qkv, masked):
    q, k, v, mask = qkv
    jp = JA.init_multi_head(jax.random.PRNGKey(10), D, num_heads=4)
    pp = carry(jp, PA.init_multi_head, D, num_heads=4)
    m = mask if masked else None
    close(PA.multi_head_attention(pp, t(q), t(k), t(v), None if m is None else t(m)),
          JA.multi_head_attention(jp, q, k, v, m))


@pytest.mark.parametrize("masked", [False, True])
def test_relative_multi_head(qkv, masked):
    _, k, v, mask = qkv
    rs = np.random.RandomState(11)
    q, pos = arr(rs, B, LK, D), arr(rs, B, LK, D)
    m = (rs.rand(B, LK, LK) < 0.3) if masked else None
    jp = JA.init_relative_multi_head(jax.random.PRNGKey(12), D, num_heads=4)
    pp = carry(jp, PA.init_relative_multi_head, D, num_heads=4)
    close(PA.relative_multi_head_attention(pp, t(q), t(k), t(v), t(pos),
                                           None if m is None else t(m)),
          JA.relative_multi_head_attention(jp, q, k, v, pos, m))
    x = arr(rs, 2, 3, 4, 5)
    close(PA._rel_shift(t(x)), JA._rel_shift(x))


def test_customizing(qkv):
    q, _, v, _ = qkv
    jp = JA.init_customizing(jax.random.PRNGKey(13), D, num_heads=4)
    pp = carry(jp, PA.init_customizing, D, num_heads=4)
    last = np.random.RandomState(14).rand(B * 4, LK).astype(np.float32)
    for la in (None, last):
        close(PA.customizing_attention(pp, t(q), t(v), None if la is None else t(la)),
              JA.customizing_attention(jp, q, v, la))


def test_conv1d_same():
    rs = np.random.RandomState(15)
    x, w, b = arr(rs, 2, 9, 3), arr(rs, 3, 3, 5), arr(rs, 5)
    close(PA._conv1d_same(t(x), t(w), t(b)), JA._conv1d_same(x, w, b))


# ---------------------------------------------------------------------------
# the five legacy AVE modules
# ---------------------------------------------------------------------------

def test_cas_and_weakly_localization():
    rs = np.random.RandomState(16)
    jc = JL.init_cas_module(jax.random.PRNGKey(17), 32)
    content = arr(rs, 2, 10, 32)
    close(PL.cas_module(carry(jc, PL.init_cas_module, 32), t(content)), JL.cas_module(jc, content))
    jw = JL.init_weakly_localization(jax.random.PRNGKey(18), 32)
    fused = arr(rs, 10, 2, 32)
    close(PL.weakly_localization(carry(jw, PL.init_weakly_localization, 32), t(fused)),
          JL.weakly_localization(jw, fused))


def test_audio_visual_contrastive():
    rs = np.random.RandomState(19)
    jp = JL.init_audio_visual_contrastive(jax.random.PRNGKey(20))
    video, audio = arr(rs, 20, 36, 1536, scale=0.1), arr(rs, 20, 1, 768, scale=0.1)
    maps = np.random.RandomState(21).dirichlet(np.ones(36), (20, 1)).astype(np.float32)
    got = PL.audio_visual_contrastive(carry(jp, PL.init_audio_visual_contrastive), t(video),
                                      t(audio), t(maps))
    assert got.shape == (4, 10, 1)
    close(got, JL.audio_visual_contrastive(jp, video, audio, maps))


def test_audio_visual_adapter():
    rs = np.random.RandomState(22)
    jp = JL.init_audio_visual_adapter(jax.random.PRNGKey(23))
    x, audio = arr(rs, 20, 1536), arr(rs, 20, 768)
    close(PL.audio_visual_adapter(carry(jp, PL.init_audio_visual_adapter), t(x), t(audio)),
          JL.audio_visual_adapter(jp, x, audio))


def test_new_audio_guided_attention():
    rs = np.random.RandomState(24)
    jp = JL.init_new_audio_guided_attention(jax.random.PRNGKey(25))
    video, audio = arr(rs, 2, 10, 3, 3, 512, scale=0.3), arr(rs, 10, 2, 128)
    pp = carry(jp, PL.init_new_audio_guided_attention)
    close(PL.new_audio_guided_attention(pp, t(video), t(audio)),
          JL.new_audio_guided_attention(jp, video, audio))
    out = PL.new_audio_guided_attention(pp, t(video), t(audio), train=True,
                                        gen=torch.Generator().manual_seed(0))
    assert out.shape == (2, 10, 512) and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# AST, ModifiedResNet, AVENet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(8, 4, 6), (4, 6, 9), (6, 3, 9), (5, 8, 2), (6, 6, 6)],
                         ids=["shrink", "grow", "crop_f_grow_t", "grow_f_crop_t", "same"])
def test_adapt_pos_embed(dims):
    """Centre crops when an axis shrinks, JAX's bilinear `jax.image.resize`
    (half-pixel, upsampling) when it grows."""
    old, f, tt = dims
    pe = arr(np.random.RandomState(old * 10 + f), old * old + 2, 5)
    got = PLB.adapt_pos_embed(t(pe), old, f, tt)
    assert got.shape == (f * tt + 2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(JLB.adapt_pos_embed(jnp.asarray(pe), old,
                                                                           f, tt)), atol=1e-6)


AST_KW = dict(label_dim=5, fstride=10, tstride=8, input_fdim=32, input_tdim=48, embed_dim=32,
              depth=2, num_heads=2)


@pytest.mark.parametrize("apply_head", [False, True])
def test_ast_forward(apply_head):
    rs = np.random.RandomState(26)
    jp, pp = port_weights(JLB.init_ast, PLB.init_ast, **AST_KW)
    assert PLB.ast_grid(32, 48, 10, 8) == JLB.ast_grid(32, 48, 10, 8) == (2, 5)
    x = arr(rs, 2, 48, 32)
    extra = arr(rs, 2, 3, 32, scale=0.1)
    close(PLB.ast_forward(pp, t(x), num_heads=2, apply_head=apply_head),
          JLB.ast_forward(jp, x, num_heads=2, apply_head=apply_head))
    close(PLB.ast_forward(pp, t(x), num_heads=2, additional_patch=t(extra)),
          JLB.ast_forward(jp, x, num_heads=2, additional_patch=extra))


def scrambled_state(st, rs):
    """Seeded running statistics for every BN of a JAX state tree."""
    def bn(s):
        n = s["mean"].shape[0]
        return dict(s, mean=arr(rs, n, scale=0.1), var=(0.5 + rs.rand(n)).astype(np.float32))
    if isinstance(st, list):
        return [scrambled_state(v, rs) for v in st]
    if "mean" in st:
        return bn(st)
    return {k: scrambled_state(v, rs) for k, v in st.items()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_modified_resnet(train):
    rs = np.random.RandomState(28)
    kw = dict(layers=(1, 2, 1, 1), output_dim=16, heads=2, input_resolution=64, width=8)
    (jp, js), (pp, ps) = port_weights(JLB.init_modified_resnet, PLB.init_modified_resnet,
                                        **kw)
    js = scrambled_state(js, rs)
    ps = from_jax_tree(js, ps, device="cpu")
    x = arr(rs, 2, 64, 64, 3)
    out, new = PLB.modified_resnet(pp, ps, t(x), train=train)
    ref, ref_new = JLB.modified_resnet(jp, js, x, train=train)
    close(out, ref)
    close(tree_map(lambda a: a.float(), new), jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), ref_new))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_avenet(train):
    rs = np.random.RandomState(30)
    (jp, js), (pp, ps) = port_weights(JLB.init_avenet, PLB.init_avenet)
    js = scrambled_state(js, rs)
    ps = from_jax_tree(js, ps, device="cpu")
    spec = arr(rs, 2, 64, 40)
    out, new = PLB.avenet(pp, ps, t(spec), train=train)
    assert out.shape == (2, 309)
    ref, ref_new = JLB.avenet(jp, js, spec, train=train)
    close(out, ref)
    close(tree_map(lambda a: a.float(), new), jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), ref_new))


def test_carrier_checks_non_array_leaves():
    """A head count or a stride that differs from the port's tree raises,
    as a misshapen or missing leaf does."""
    jp = JA.init_multi_head(jax.random.PRNGKey(32), D, num_heads=4)
    with pytest.raises(ValueError, match="num_heads"):
        carry(dict(jp, num_heads=8), PA.init_multi_head, D, num_heads=4)
    with pytest.raises(ValueError, match="missing"):
        carry({k: v for k, v in jp.items() if k != "key_proj"}, PA.init_multi_head, D, num_heads=4)
    (jb, _), _ = port_weights(JLB.init_basic_block, PLB.init_basic_block, 4, 8, stride=2)
    ref, _ = PLB.init_basic_block(META, 4, 8, stride=1)
    with pytest.raises(ValueError, match="stride"):
        from_jax_tree(jb, ref, device="cpu")
    assert [k for k, _ in tree_paths(carry(jp, PA.init_multi_head, D, num_heads=4))] == \
        [k for k, _ in tree_paths(jp)]
