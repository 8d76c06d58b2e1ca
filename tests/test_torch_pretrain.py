"""The port's pretrain model (dg_sct_tpu_torch: configs.CLIPConfig,
PromptConfig, PretrainModelConfig, models.clip, models.prompt_learner,
htsat.tscam_head and tscam_latent, models.pretrain, weights.from_jax)
against the JAX package on the same numpy inputs and weights, float32 with
JAX at matmul precision "highest", kernels off or on CPU tensors (their
plain versions).

The tiny configuration is tests/test_pretrain_model.py's (the tiny HTS-AT
of tests/test_ave_model.py, a 4-block ViT of width 24 on 32x32 frames, a
2-block text tower of width 16, 3 classes, 2 frames). Weights come from the
port's initialiser as numpy (JAX's own initialiser takes ~35 s on the CPU;
its tree is held to the port's by shapes through `jax.eval_shape`), with
every adapter's gates and BN statistics set from a seed (zero-gated at
init, the adapters would not count).

Tolerances: the CLIP halves, towers and the tscam head at atol 1e-5 / rtol
1e-4 (a few float32 sums); the prompt buffers and assembled prompts exact;
the latent route bit for bit against the whole tscam head; the tiny
forward's v_cls, a_cls, contrastive logits, clip_matching and
clap_matching at atol 2e-4 / rtol 2e-3, as tests/test_torch_avs.py holds
the AVS model. event_scores = (lv^2 + la^2) / (lv + la) divides by a sum
that nothing keeps from zero, so each element is held within its own bound:
the error bound e of the logits (atol + rtol |logit|) times the sum of the
absolute partial derivatives, |lv^2 + 2 lv la - la^2| / (lv + la)^2 and the
same with lv and la swapped, plus atol; the test prints the smallest
|lv + la| of its batch beside the largest bound.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu import configs as JC
from dg_sct_tpu.models import adapter as JAd
from dg_sct_tpu.models import clip as JCl
from dg_sct_tpu.models import htsat as JH
from dg_sct_tpu.models import pretrain as JP
from dg_sct_tpu.models import prompt_learner as JPL
from dg_sct_tpu.ops import basic as JB
import dg_sct_tpu_torch.configs as PC
from dg_sct_tpu_torch.models import clip as PCl
from dg_sct_tpu_torch.models import htsat as PH
from dg_sct_tpu_torch.models import pretrain as PP
from dg_sct_tpu_torch.models import prompt_learner as PPL
from dg_sct_tpu_torch.models.interleave import fold_adapters_eval
from dg_sct_tpu_torch.ops.basic import Init
from dg_sct_tpu_torch.weights import from_jax
from test_ave_model import tiny_cfg
from test_pretrain_model import tiny_clip
from test_torch_avs import _fields, _shapes, close
from torch_port_helpers import scramble_adapters, to_numpy, to_torch

S_ATOL, S_RTOL = 1e-5, 1e-4      # the CLIP halves and towers, the tscam head
ATOL, RTOL = 2e-4, 2e-3          # the tiny forward
NAMES = ["dog", "violin_fiddle", "Speech"]
OUTPUTS = ("v_cls", "a_cls", "logits_audio_image", "logits_image_audio")


def tiny_pretrain_cfg():
    """tests/test_pretrain_model.py's tiny configuration."""
    base = tiny_cfg()
    return JC.PretrainModelConfig(
        clip=tiny_clip(vision_layers=sum(base.htsat.depths)), htsat=base.htsat,
        adapter=JC.AdapterConfig(reduction_factor=2, num_tokens=4), num_frames=2,
        num_classes=len(NAMES))


def port_pretrain_cfg(jcfg):
    """The port's PretrainModelConfig with every field of the JAX one."""
    h = jcfg.htsat
    frontend = PC.AudioFrontendConfig(**_fields(h.frontend, stft_compute=None))
    return PC.PretrainModelConfig(
        clip=PC.CLIPConfig(**_fields(jcfg.clip)),
        htsat=PC.HTSATConfig(**_fields(h, frontend=frontend)),
        adapter=PC.AdapterConfig(**_fields(jcfg.adapter)),
        prompt=PC.PromptConfig(**_fields(jcfg.prompt)),
        num_frames=jcfg.num_frames, num_classes=jcfg.num_classes)


def jax_init_shapes(jcfg, names):
    """JAX's init_pretrain_model as shapes (`jax.eval_shape`): its prompt
    buffers are built on the host from the token embedding's values, so for
    shapes they read zeros of the embedding's shape."""
    real = JPL.build_prompt_buffers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP.jax, "device_get", lambda x: x)
        mp.setattr(JP.P, "build_prompt_buffers", lambda n, emb, p, c: real(
            n, np.zeros(emb.shape, np.float32), p, c))
        return jax.eval_shape(lambda k: JP.init_pretrain_model(k, jcfg, names)[:2],
                              jax.random.PRNGKey(0))


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores; a full set of intra-op threads
    in each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_configs_match_jax():
    for j, p in ((JC.CLIPConfig(), PC.CLIPConfig()), (JC.PromptConfig(), PC.PromptConfig())):
        assert _fields(j) == _fields(p)
    j, p = JC.PretrainModelConfig(), PC.PretrainModelConfig()
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(p)]
    assert (j.num_frames, j.num_classes) == (p.num_frames, p.num_classes) == (10, 141)
    assert _fields(j.adapter) == _fields(p.adapter)
    jh, ph = _fields(j.htsat), _fields(p.htsat)
    jh.pop("frontend"), ph.pop("frontend")
    assert jh == ph
    assert p.compute_dtype == torch.float32


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_init_tree_matches_jax(width):
    """The port's (params, state) on "meta" against JAX's tree: the same keys,
    list lengths and shapes; at full width 141 classes."""
    jcfg = tiny_pretrain_cfg() if width == "tiny" else JC.PretrainModelConfig()
    names = NAMES if width == "tiny" else [f"class {i}" for i in range(141)]
    pp, ps, buf = PP.init_pretrain_model(port_pretrain_cfg(jcfg), names, device="meta")
    jp, js = jax_init_shapes(jcfg, names)
    assert _shapes(pp) == _shapes(jp)
    assert _shapes(ps) == _shapes(js)
    assert len(pp["adapters"]["v_p1"]) == jcfg.clip.vision_layers
    assert buf["token_suffix"].shape == (len(names), 72, jcfg.clip.text_width)


# ---------------------------------------------------------------------------
# CLIP towers and the prompt learner
# ---------------------------------------------------------------------------

def _params(make, seed):
    """A port init (`make(Init)`) as a numpy tree for JAX and CPU tensors for
    the port."""
    tree = to_numpy(make(Init(torch.Generator().manual_seed(seed), "cpu")))
    return tree, to_torch(tree)


def test_quick_gelu_matches_jax():
    x = np.linspace(-6, 6, 97).astype(np.float32)
    close(PCl.quick_gelu(torch.from_numpy(x)), JCl.quick_gelu(jnp.asarray(x)), 1e-6, 1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["visual", "causal"])
def test_resblock_halves_match_jax(masked):
    jp, pp = _params(lambda i: PCl.init_resblock(i, 24), 0)
    x = np.random.RandomState(0).randn(3, 9, 24).astype(np.float32)
    jm = JCl.causal_mask(9) if masked else None
    pm = PCl.causal_mask(9, device="cpu") if masked else None
    xj, xp = jnp.asarray(x), torch.from_numpy(x)
    close(PCl.attention_part(pp, xp, num_heads=2, mask=pm),
          JCl.attention_part(jp, xj, num_heads=2, mask=jm), S_ATOL, S_RTOL)
    close(PCl.mlp_part(pp, xp), JCl.mlp_part(jp, xj), S_ATOL, S_RTOL)
    close(PCl.resblock(pp, xp, num_heads=2, mask=pm),
          JCl.resblock(jp, xj, num_heads=2, mask=jm), S_ATOL, S_RTOL)


def test_bf16_attention_scores_in_float32():
    """In bf16 the scores are float32, softmaxed, then cast (as JAX orders
    it): the port's bf16 attention half within bf16 rounding of JAX's."""
    jp, pp = _params(lambda i: PCl.init_resblock(i, 24), 1)
    x = np.random.RandomState(1).randn(2, 7, 24).astype(np.float32)
    bf = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), t)
    ref = JCl.attention_part(bf(jp), jnp.asarray(x, jnp.bfloat16), num_heads=2)
    got = PCl.attention_part(jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16), pp),
                             torch.from_numpy(x).to(torch.bfloat16), num_heads=2)
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(ref, np.float32), 3e-2, 3e-2)


def test_visual_and_text_towers_match_jax():
    ccfg = tiny_clip()
    pcfg = PC.CLIPConfig(**_fields(ccfg))
    jv, pv = _params(lambda i: PCl.init_visual(i, pcfg), 2)
    jt, pt = _params(lambda i: PCl.init_text(i, pcfg), 3)
    rs = np.random.RandomState(2)
    imgs = rs.rand(3, 32, 32, 3).astype(np.float32)
    close(PCl.visual_embed(pv, torch.from_numpy(imgs), pcfg),
          JCl.visual_embed(jv, jnp.asarray(imgs), ccfg), S_ATOL, S_RTOL)
    close(PCl.visual_forward(pv, torch.from_numpy(imgs), pcfg),
          JCl.visual_forward(jv, jnp.asarray(imgs), ccfg), S_ATOL, S_RTOL)
    tok = np.zeros((2, 77), np.int32)
    tok[0, :5] = [49406, 10, 20, 30, 49407]
    tok[1, :3] = [49406, 11, 49407]
    got = PCl.encode_text(pt, torch.from_numpy(tok), pcfg)
    close(got, JCl.encode_text(jt, jnp.asarray(tok), ccfg), S_ATOL, S_RTOL)
    tok[0, 50] = 123  # after the EOT: the causal mask hides it
    assert torch.equal(PCl.encode_text(pt, torch.from_numpy(tok), pcfg)[0], got[0])


@pytest.mark.parametrize("ctx_init", ["a photo of a", ""], ids=["ctx_init", "random_ctx"])
@pytest.mark.parametrize("weak", [True, False], ids=["weak", "background"])
def test_prompt_buffers_match_jax(ctx_init, weak):
    ccfg = tiny_clip()
    jpc = JC.PromptConfig(ctx_init=ctx_init, weak=weak)
    emb = np.random.RandomState(4).randn(49408, ccfg.text_width).astype(np.float32)
    ref = JPL.build_prompt_buffers(NAMES, emb, jpc, ccfg)
    got = PPL.build_prompt_buffers(NAMES, torch.from_numpy(emb),
                                   PC.PromptConfig(**_fields(jpc)), PC.CLIPConfig(**_fields(ccfg)))
    for k in ("ctx_init", "token_prefix", "token_suffix", "tokenized"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert got["name_lens"] == ref["name_lens"] and got["n_ctx"] == ref["n_ctx"]
    assert got["tokenized"].shape[0] == len(NAMES) + (0 if weak else 1)


@pytest.mark.parametrize("position", ["end", "middle", "front"])
def test_build_prompts_match_jax(position):
    ccfg = tiny_clip()
    emb = np.random.RandomState(5).randn(49408, ccfg.text_width).astype(np.float32)
    buffers = JPL.build_prompt_buffers(NAMES, emb, JC.PromptConfig(), ccfg)
    pbuf = PPL.build_prompt_buffers(NAMES, torch.from_numpy(emb), PC.PromptConfig(),
                                    PC.CLIPConfig(**_fields(ccfg)))
    jp, pp = _params(lambda i: PPL.init_prompt_learner(i, pbuf, 16, ccfg.text_width), 5)
    jp["ctx"] = np.random.RandomState(6).randn(*jp["ctx"].shape).astype(np.float32)
    pp["ctx"] = torch.from_numpy(jp["ctx"])
    ref = JPL.build_prompts(jp, buffers, class_token_position=position)
    got = PPL.build_prompts(pp, pbuf, class_token_position=position)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if position != "end":  # the names (of differing lengths) moved, not just the ctx
        assert not np.array_equal(got.numpy(), np.asarray(JPL.build_prompts(
            jp, buffers, class_token_position="end")))


def test_clip_adapter_matches_jax():
    jp, pp = _params(lambda i: PPL.init_clip_adapter(i, 16, 4), 7)
    x = np.random.RandomState(7).randn(5, 16).astype(np.float32)
    close(PPL.clip_adapter(pp, torch.from_numpy(x)), JPL.clip_adapter(jp, jnp.asarray(x)),
          S_ATOL, S_RTOL)


# ---------------------------------------------------------------------------
# the tscam head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", ["tiny", "full"])
def test_tscam_head_matches_jax(width):
    """All three outputs against JAX's; the latent route bit for bit against
    the whole head's latent. At full width the head folds 2 freq strips."""
    jh = tiny_pretrain_cfg().htsat if width == "tiny" else JC.HTSATConfig()
    ph = port_pretrain_cfg(JC.PretrainModelConfig(htsat=jh)).htsat
    full = lambda i: PH.init_htsat(i, ph)[0]
    jp, pp = _params(lambda i: {k: full(i)[k] for k in ("norm", "tscam_conv")}, 8)
    jp["tscam_conv"]["bias"] = np.random.RandomState(8).randn(
        *jp["tscam_conv"]["bias"].shape).astype(np.float32)
    pp["tscam_conv"]["bias"] = torch.from_numpy(jp["tscam_conv"]["bias"])
    r = ph.stage_resolution(ph.num_layers - 1)
    x = np.random.RandomState(9).randn(3, r[0] * r[1], ph.num_features).astype(np.float32)
    ref = jax.jit(lambda p, x: JH.tscam_head(p, x, jh))(jp, x)
    got = PH.tscam_head(pp, torch.from_numpy(x), ph)
    assert PH.tscam_freq_bins(ph) == (2 if width == "full" else 1)
    for k in ("clipwise_output", "framewise_output", "latent_output"):
        assert got[k].shape == ref[k].shape, k
        close(got[k], ref[k], S_ATOL, S_RTOL, msg=k)
    assert torch.equal(PH.tscam_latent(pp, torch.from_numpy(x), ph), got["latent_output"])


# ---------------------------------------------------------------------------
# the tiny pretrain forward
# ---------------------------------------------------------------------------

def jax_forward(jcfg, buffers, train=False):
    """JAX's forward, jitted over (params, state, wave, images) with the
    buffers closed over (their ints steer Python control flow); the outputs
    also hold clip_matching's logits_v and clap_matching's logits_a."""
    def run(p, s, w, i):
        out, st = JP.forward(p, s, buffers, w, i, jcfg, train=train)
        return dict(out, logits_v=JP.clip_matching(p, buffers, out["v_cls"], jcfg),
                    logits_a=JP.clap_matching(p, out["a_cls"])), st
    return jax.jit(run)


def jax_fold(jp, js, jcfg):
    """JAX's `adapter.fold_eval` over every adapter."""
    pairs = {k: [JAd.fold_eval(a, s, jcfg.adapter) for a, s in zip(jp["adapters"][k],
                                                                   js["adapters"][k])]
             for k in jp["adapters"]}
    return (dict(jp, adapters={k: [p for p, _ in v] for k, v in pairs.items()}),
            dict(js, adapters={k: [s for _, s in v] for k, v in pairs.items()}))


@pytest.fixture(scope="module")
def tiny():
    """Seeded tiny weights (the port's initialiser) with nonzero adapter gates
    and BN statistics, as numpy for JAX and carried across by from_jax;
    JAX's buffers from the same token embedding; seeded inputs; JAX's eval,
    folded eval and train forwards, run once each."""
    jcfg = tiny_pretrain_cfg()
    pcfg = port_pretrain_cfg(jcfg)
    pp0, ps0, _ = PP.init_pretrain_model(pcfg, NAMES, seed=1, device="cpu")
    jp, js = scramble_adapters(to_numpy(pp0), to_numpy(ps0), seed=1)
    buffers = JPL.build_prompt_buffers(NAMES, jp["text"]["token_embedding"], jcfg.prompt,
                                       jcfg.clip)
    pp, ps, pbuf = from_jax(jp, js, pcfg, device="cpu", classnames=NAMES)
    rs = np.random.RandomState(3)
    B, T = 2, jcfg.num_frames
    wave = (0.3 * rs.randn(B, T, jcfg.htsat.frontend.clip_samples)).astype(np.float32)
    imgs = rs.rand(B, T, 32, 32, 3).astype(np.float32)
    jfp, jfs = jax_fold(jp, js, jcfg)
    ref = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")  # the parity form, whatever ran before
        for name, (p, s, train) in {"eval": (jp, js, False), "folded": (jfp, jfs, False),
                                    "train": (jp, js, True)}.items():
            ref[name] = jax.tree_util.tree_map(
                np.asarray, jax_forward(jcfg, buffers, train)(p, s, wave, imgs))
    return dict(jcfg=jcfg, pcfg=pcfg, jp=jp, js=js, buffers=buffers, pp=pp, ps=ps, pbuf=pbuf,
                wave=wave, imgs=imgs, ref=ref)


def event_bound(logits_v, logits_a, atol=ATOL, rtol=RTOL):
    """Each event score's bound: the logits' error bound e = atol + rtol
    max(|lv|, |la|) through the partial derivatives of (lv^2 + la^2) / (lv +
    la), plus atol -> (bound, lv + la)."""
    lv, la = (np.asarray(x, np.float64) for x in (logits_v, logits_a))
    denom = lv + la
    err = atol + rtol * np.maximum(np.abs(lv), np.abs(la))
    slope = (np.abs(lv ** 2 + 2 * lv * la - la ** 2)
             + np.abs(la ** 2 + 2 * lv * la - lv ** 2)) / denom ** 2
    return atol + err * slope, denom


def check_outputs(got, ref):
    """The forward's outputs against JAX's: each at (ATOL, RTOL) but
    event_scores, held per element within the bound its logits' error
    carries through 1 / (lv + la)."""
    for k in OUTPUTS:
        close(got[k], ref[k], ATOL, RTOL, msg=k)
    bound, denom = event_bound(ref["logits_v"], ref["logits_a"])
    diff = np.abs(got["event_scores"].numpy() - ref["event_scores"])
    print(f"event_scores: smallest |logits_v + logits_a| {np.abs(denom).min():.4e}, largest "
          f"bound {bound.max():.4e}, largest |diff| / bound {(diff / bound).max():.3e}")
    assert (diff <= bound).all(), (diff.max(), bound[diff > bound])


def _port(t, params=None, state=None, **kw):
    return PP.forward(t["pp"] if params is None else params, t["ps"] if state is None else state,
                      t["pbuf"], t["wave"], t["imgs"], t["pcfg"], device="cpu", **kw)


def test_from_jax_rebuilds_the_buffers(tiny):
    """Every leaf carried across as it was; the buffers rebuilt from the
    carried token embedding equal JAX's; a missing leaf raises."""
    t = tiny
    for (path, leaf), (_, want) in zip(jax.tree_util.tree_flatten_with_path(t["pp"])[0],
                                       jax.tree_util.tree_flatten_with_path(t["jp"])[0]):
        np.testing.assert_array_equal(leaf.numpy(), want, err_msg=str(path))
    for k in ("ctx_init", "token_prefix", "token_suffix", "tokenized"):
        np.testing.assert_array_equal(t["pbuf"][k].numpy(), t["buffers"][k], err_msg=k)
    assert (t["pbuf"]["name_lens"], t["pbuf"]["n_ctx"]) == (t["buffers"]["name_lens"],
                                                            t["buffers"]["n_ctx"])
    broken = dict(t["jp"], clip_adapter={})
    with pytest.raises(ValueError, match="missing keys"):
        from_jax(broken, t["js"], t["pcfg"], device="cpu", classnames=NAMES)
    with pytest.raises(ValueError, match="classnames"):
        from_jax(t["jp"], t["js"], t["pcfg"], device="cpu")


def test_eval_forward_matches_jax(tiny):
    """Unfolded adapters, with kernels (K2's plain version on the CPU) and
    without."""
    with torch.inference_mode():
        for kernels in (True, False):
            got = _port(tiny, kernels=kernels)
            assert set(got) == set(OUTPUTS) | {"event_scores"}
            assert got["event_scores"].shape == (4, len(NAMES))
            check_outputs(got, tiny["ref"]["eval"][0])


def test_folded_forward_matches_jax(tiny):
    """Adapters folded by the port's `fold_adapters_eval` against JAX's
    forward on JAX's `fold_eval`: with kernels (K3's and K2's plain
    versions on the CPU) and without."""
    t = tiny
    fp, fs = fold_adapters_eval(t["pp"], t["ps"], t["pcfg"])
    assert all({"bn1", "bn2", "gate"}.isdisjoint(a) for k in fp["adapters"]
               for a in fp["adapters"][k])
    with torch.inference_mode():
        for kernels in (True, False):
            check_outputs(_port(t, fp, fs, kernels=kernels), t["ref"]["folded"][0])


def test_train_forward_matches_jax(tiny):
    """Train mode without a generator (bn0 and the adapters' BNs on the
    batch's statistics; JAX's rng=None draws no SpecAugment): outputs and
    the new state."""
    t = tiny
    got, state = _port(t, train=True)
    ref, ref_state = t["ref"]["train"]
    check_outputs({k: v.detach() for k, v in got.items()}, ref)
    for (path, leaf), (_, want) in zip(jax.tree_util.tree_flatten_with_path(state)[0],
                                       jax.tree_util.tree_flatten_with_path(ref_state)[0]):
        close(leaf, want, ATOL, RTOL, msg=str(path))
    assert int(state["htsat"]["bn0"]["count"]) == 1
    assert int(state["adapters"]["v_p2"][0]["bn1"]["count"]) == 1


def test_latent_route_matches_the_whole_head(tiny):
    """The forward's audio head reads tscam_latent, bit for bit the head's
    latent_output on the same final tokens."""
    t = tiny
    y = torch.randn(4, 1, t["pcfg"].htsat.num_features, generator=torch.Generator().manual_seed(0))
    head = PH.tscam_head(t["pp"]["htsat"], y, t["pcfg"].htsat)
    assert torch.equal(PH.tscam_latent(t["pp"]["htsat"], y, t["pcfg"].htsat),
                       head["latent_output"])
