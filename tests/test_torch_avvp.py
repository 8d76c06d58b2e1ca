"""The port's AVVP model (dg_sct_tpu_torch: configs.AVVPModelConfig,
models.grouping, models.avvp, ops.quant.calibrate_avvp, weights.from_jax)
against the JAX package on the same numpy inputs and weights, float32 with
JAX at matmul precision "highest", kernels off (their plain versions).

Tolerances: each grouping function, the slim temporal attention and the
whole tiny AVVP eval forward (all seven outputs, adapters scrambled and
class tokens nonzero) at atol 2e-4 / rtol 2e-3, as tests/test_torch_avs.py
holds the AVS model; the grouping functions at atol 1e-4 / rtol 1e-3; the
hard assignment's one-hot exactly, with each case's smallest top-1/top-2
margin asserted well above float32 noise so that a flipped argmax cannot
hide; DG-SCT's own AVVP modules through the goldens (tests/golden/refgold_avvp_*)
at tests/test_reference_golden.py's tolerances; the int8 forward within
half of JAX's int8-against-float drift (as tests/test_torch_quant.py)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu import configs as JC
from dg_sct_tpu.models import avvp as JV
from dg_sct_tpu.models import grouping as JG
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.ops import quant as JQ
import dg_sct_tpu_torch.configs as PC
from dg_sct_tpu_torch.models import adapter as PAd
from dg_sct_tpu_torch.models import avvp as PV
from dg_sct_tpu_torch.models import grouping as PG
from dg_sct_tpu_torch.ops import quant as PQ
from dg_sct_tpu_torch.ops.basic import Init
from dg_sct_tpu_torch.utils import torch_convert as PTC
from dg_sct_tpu_torch.weights import from_jax
from gen_reference_goldens import ADAPTER_SPECS
from refgold_common import load_census, outputs_path, rebuild_sd, synth
from test_avvp_model import tiny_avvp_cfg
from test_torch_avs import _fields, _shapes, close
from torch_port_helpers import scramble_adapters, to_numpy, to_torch

G_ATOL, G_RTOL = 1e-4, 1e-3      # each grouping function
MIN_MARGIN = 1e-3                # a hard assignment's smallest top-1/top-2 gap of softmax
MIN_DIM = 16                     # int8 at tiny widths, as tests/test_torch_quant.py
DRIFT_SHARE = 0.5                # int8: port against JAX, as a share of JAX's int8 drift
AVVP_FIELDS = ("num_frames", "num_classes", "dim", "depth_aud", "depth_vis", "depth_av",
               "unimodal_assign", "crossmodal_assign")
OUTPUTS = ("aud_cls_prob", "vis_cls_prob", "global_prob", "a_prob", "v_prob", "a_frame_prob",
           "v_frame_prob")


def port_avvp_cfg(jcfg):
    """The port's AVVPModelConfig with every field of the JAX one."""
    h = jcfg.htsat
    frontend = PC.AudioFrontendConfig(**_fields(h.frontend, stft_compute=None))
    return PC.AVVPModelConfig(
        swin=PC.SwinV2Config(**_fields(jcfg.swin)),
        htsat=PC.HTSATConfig(**_fields(h, frontend=frontend)),
        adapter=PC.AdapterConfig(**_fields(jcfg.adapter)),
        **{k: getattr(jcfg, k) for k in AVVP_FIELDS})


def scramble_avvp(params, state, seed=0):
    """`scramble_adapters` and class tokens from `seed` in a numpy AVVP tree:
    the adapters are zero-gated and the tokens zero at init, which would
    hide the adapters and degenerate the grouping."""
    params, state = scramble_adapters(params, state, seed)
    rs = np.random.RandomState(seed + 100)
    for k in ("audio_token", "visual_token"):
        params[k] = (0.5 * rs.randn(*params[k].shape)).astype(np.float32)
    return params, state


def tiny_inputs(cfg, B=2, seed=1):
    rs = np.random.RandomState(seed)
    T = cfg.num_frames
    return ((0.3 * rs.randn(B, T, cfg.htsat.frontend.clip_samples)).astype(np.float32),
            rs.rand(B, T, cfg.swin.img_size, cfg.swin.img_size, 3).astype(np.float32),
            rs.randn(B, T, 512).astype(np.float32))


def jax_forward(jcfg):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")  # the parity form, whatever ran before
        return jax.jit(lambda p, s, w, i, v: JV.forward(p, s, w, i, v, jcfg)[0])


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores; a full set of intra-op threads
    in each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """Seeded tiny AVVP weights (the port's initialiser) with scrambled
    adapters and nonzero class tokens, as numpy for JAX and carried across
    by from_jax; seeded inputs; JAX's forward, run once."""
    jcfg = tiny_avvp_cfg()
    pcfg = port_avvp_cfg(jcfg)
    jp, js = scramble_avvp(*(to_numpy(t) for t in PV.init_avvp_model(pcfg, device="cpu")))
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    wave, imgs, st = tiny_inputs(jcfg)
    fwd = jax_forward(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        ref = jax.tree_util.tree_map(np.asarray, fwd(jp, js, wave, imgs, st))
    return dict(jcfg=jcfg, pcfg=pcfg, jp=jp, js=js, pp=pp, ps=ps, wave=wave, imgs=imgs, st=st,
                ref=ref, fwd=fwd)


def _port_forward(t, params=None, cfg=None, **kw):
    with torch.inference_mode():
        return PV.forward(t["pp"] if params is None else params, t["ps"], t["wave"], t["imgs"],
                          t["st"], cfg or t["pcfg"], device="cpu", kernels=False, **kw)


def test_config_matches_jax():
    j, p = JC.AVVPModelConfig(), PC.AVVPModelConfig()
    skip = ("compute_dtype", "swin", "htsat", "adapter")
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(p)]
    assert {k: v for k, v in _fields(j).items() if k not in skip} == {
        k: v for k, v in _fields(p).items() if k not in skip}
    for name in ("swin", "htsat", "adapter"):
        jf, pf = _fields(getattr(j, name)), _fields(getattr(p, name))
        jf.pop("frontend", None), pf.pop("frontend", None)
        assert jf == pf, name
    assert p.compute_dtype == torch.float32
    assert (p.dim, p.depth_aud, p.depth_vis, p.depth_av, p.num_classes) == (128, 3, 3, 6, 25)


def test_init_tree_matches_jax_at_full_width():
    """init_avvp_model's tree and shapes on "meta" equal JAX's (eval_shape)."""
    pp, ps = PV.init_avvp_model(PC.AVVPModelConfig(), device="meta")
    jp, js = jax.eval_shape(lambda k: JV.init_avvp_model(k, JC.AVVPModelConfig()),
                            jax.random.PRNGKey(0))
    assert _shapes(pp) == _shapes(jp)
    assert _shapes(ps) == _shapes(js)


# ---------------------------------------------------------------------------
# grouping functions
# ---------------------------------------------------------------------------

DIM, HEADS = 16, 4


def _params(make, seed):
    """A port init (`make(Init)`) as a numpy tree for JAX and CPU tensors for
    the port."""
    tree = to_numpy(make(Init(torch.Generator().manual_seed(seed), "cpu")))
    return tree, to_torch(tree)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _margin(logits, axis):
    """The smallest gap between the largest and second-largest softmax value
    along `axis`."""
    p = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=axis)), axis=axis)
    top2 = np.take(p, [-1, -2], axis=axis)
    return float((np.take(top2, 0, axis=axis) - np.take(top2, 1, axis=axis)).min())


def test_grouping_inits_match_jax_shapes():
    init = Init(None, "meta")
    k = jax.random.PRNGKey(0)
    pairs = [
        (PG.attention_init(init, DIM, qkv_bias=True), JG.attention_init(k, DIM, qkv_bias=True)),
        (PG.attn_block_init(init, DIM), JG.attn_block_init(k, DIM)),
        (PG.cross_attn_block_init(init, DIM), JG.cross_attn_block_init(k, DIM)),
        (PG.grouping_block_init(init, DIM, DIM, 7, 5), JG.grouping_block_init(k, DIM, DIM, 7, 5)),
        (PG.modality_trans_init(init, DIM, depth=2, num_group_tokens=5, num_output_groups=5,
                                use_han=True, han_tokens=6),
         JG.modality_trans_init(k, DIM, depth=2, num_group_tokens=5, num_output_groups=5,
                                use_han=True, han_tokens=6)),
    ]
    for p, j in pairs:
        assert _shapes(p) == _shapes(j)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_attention_matches_jax(cross):
    jp, pp = _params(lambda i: PG.attention_init(i, DIM, qkv_bias=True), 1)
    q = _x(2, 5, DIM, seed=1)
    k = _x(2, 9, DIM, seed=2) if cross else None
    ref = JG.attention(jp, jnp.asarray(q), None if k is None else jnp.asarray(k), num_heads=HEADS)
    got = PG.attention(pp, torch.from_numpy(q), None if k is None else torch.from_numpy(k),
                       num_heads=HEADS)
    close(got, ref, G_ATOL, G_RTOL)


@pytest.mark.parametrize("axis", [-1, -2])
def test_hard_softmax_matches_jax(axis):
    """The one-hot forward exactly, and the straight-through gradient."""
    logits = 2.0 * _x(3, 6, 7, seed=3)
    assert _margin(logits, axis) > MIN_MARGIN
    w = _x(3, 6, 7, seed=4)
    ref = JG.hard_softmax(jnp.asarray(logits), axis)
    ref_g = jax.grad(lambda l: jnp.sum(JG.hard_softmax(l, axis) * w))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = PG.hard_softmax(lt, axis)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    assert set(np.unique(got.detach().numpy())) == {0.0, 1.0}
    close(lt.grad, ref_g, G_ATOL, G_RTOL)


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_gumbel_softmax_matches_jax_on_the_same_noise(hard):
    """JAX's gumbel_softmax draws its noise from `rng`; the port applies that
    same draw, handed in."""
    rng = jax.random.PRNGKey(5)
    logits = _x(2, 6, 9, seed=5)
    noise = np.array(jax.random.gumbel(rng, logits.shape, jnp.float32))
    if hard:
        assert _margin((logits + noise) / 0.7, -2) > MIN_MARGIN
    ref = JG.gumbel_softmax(rng, jnp.asarray(logits), tau=0.7, hard=hard, axis=-2)
    got = PG.gumbel_softmax(torch.from_numpy(logits), torch.from_numpy(noise), tau=0.7,
                            hard=hard, axis=-2)
    close(got, ref, G_ATOL, G_RTOL)


def test_gumbel_noise_draws():
    """Standard Gumbel draws from the generator: reproducible by seed, finite,
    mean near Euler's constant and variance near pi^2 / 6."""
    draw = lambda s: PG.gumbel_noise(torch.Generator().manual_seed(s), (200, 100), "cpu")
    a, b = draw(0), draw(0)
    assert torch.equal(a, b) and not torch.equal(a, draw(1))
    assert bool(torch.isfinite(a).all())
    assert abs(float(a.mean()) - 0.5772) < 0.03
    assert abs(float(a.var()) - np.pi ** 2 / 6) < 0.1
    assert PG.gumbel_noise(torch.Generator().manual_seed(0), (3,), "cpu",
                           torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_assign_attention_matches_jax(hard):
    jp, pp = _params(lambda i: PG.assign_attention_init(i, DIM), 2)
    q, k = _x(2, 5, DIM, seed=6), _x(2, 11, DIM, seed=7)
    ref, ref_attn = JG.assign_attention(jp, jnp.asarray(q), jnp.asarray(k), hard=hard,
                                        gumbel=hard, return_attn=True)
    qt = torch.from_numpy(q).requires_grad_()
    got, attn = PG.assign_attention(pp, qt, torch.from_numpy(k), hard=hard, gumbel=hard,
                                    return_attn=True)
    close(got.detach(), ref, G_ATOL, G_RTOL)
    for key in ("hard", "soft"):
        close(attn[key].detach(), ref_attn[key], G_ATOL, G_RTOL, msg=key)
    # the gradient to the groups goes through the (straight-through) assignment
    w = _x(2, 5, DIM, seed=8)
    ref_g = jax.grad(lambda qq: jnp.sum(JG.assign_attention(
        jp, qq, jnp.asarray(k), hard=hard, gumbel=hard)[0] * w))(jnp.asarray(q))
    (got * torch.from_numpy(w)).sum().backward()
    close(qt.grad, ref_g, G_ATOL, G_RTOL)


def test_assign_attention_draws_gumbel_noise_in_training_only():
    """With `gumbel`, training with a generator draws noise (the output moves
    and follows the seed); without a generator, or in eval, it is the
    noiseless assignment."""
    _, pp = _params(lambda i: PG.assign_attention_init(i, DIM), 2)
    q, k = torch.from_numpy(_x(2, 5, DIM, seed=6)), torch.from_numpy(_x(2, 11, DIM, seed=7))
    run = lambda **kw: PG.assign_attention(pp, q, k, hard=True, gumbel=True, **kw)[0]
    base = run()
    assert torch.equal(run(train=True), base)
    assert torch.equal(run(gen=torch.Generator().manual_seed(0)), base)
    a = run(train=True, gen=torch.Generator().manual_seed(0))
    b = run(train=True, gen=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, base)


def test_attn_blocks_match_jax():
    jp, pp = _params(lambda i: PG.attn_block_init(i, DIM), 3)
    x = _x(2, 7, DIM, seed=9)
    close(PG.attn_block(pp, torch.from_numpy(x), num_heads=HEADS),
          JG.attn_block(jp, jnp.asarray(x), num_heads=HEADS), G_ATOL, G_RTOL)
    jp, pp = _params(lambda i: PG.cross_attn_block_init(i, DIM), 4)
    q, k = _x(2, 5, DIM, seed=10), _x(2, 8, DIM, seed=11)
    close(PG.cross_attn_block(pp, torch.from_numpy(q), torch.from_numpy(k), num_heads=HEADS),
          JG.cross_attn_block(jp, jnp.asarray(q), jnp.asarray(k), num_heads=HEADS),
          G_ATOL, G_RTOL)


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_grouping_block_matches_jax(hard):
    jp, pp = _params(lambda i: PG.grouping_block_init(i, DIM, DIM, 7, 5), 5)
    x, g = _x(2, 9, DIM, seed=12), _x(2, 7, DIM, seed=13)
    ref, ref_attn = JG.grouping_block(jp, jnp.asarray(x), jnp.asarray(g), num_heads=HEADS,
                                      hard=hard, gumbel=hard, return_attn=True)
    got, attn = PG.grouping_block(pp, torch.from_numpy(x), torch.from_numpy(g), num_heads=HEADS,
                                  hard=hard, gumbel=hard, return_attn=True)
    close(got, ref, G_ATOL, G_RTOL)
    close(attn["hard"], ref_attn["hard"], G_ATOL, G_RTOL)


def _han_margin(jp, x, g, xo):
    """The HAN assignment's smallest top-1/top-2 softmax margin over the
    group axis, from JAX's own intermediates."""
    cat = jnp.concatenate([jnp.asarray(x), jnp.broadcast_to(jnp.asarray(g)[None],
                                                            (x.shape[0],) + g.shape)], 1)
    for bp in jp["blocks"]:
        cat = JG.attn_block(bp, cat, num_heads=8)
    hp = jp["han_encoder"]
    tokens = JB.layer_norm(hp["norm_x"], cat[:, :x.shape[1]])
    groups = JB.layer_norm(hp["norm_tokens"], jnp.asarray(xo))
    proj = JB.mlp(hp["mlp_inter"], groups.transpose(0, 2, 1)).transpose(0, 2, 1)
    proj = JG.cross_attn_block(hp["pre_assign_attn"], JB.layer_norm(hp["norm_post_tokens"], proj),
                               tokens, num_heads=8)
    a = hp["assign"]
    raw = JB.linear(a["q_proj"], proj) @ JB.linear(a["k_proj"], tokens).transpose(0, 2, 1)
    return _margin(raw * DIM ** -0.5, -2)


@pytest.mark.parametrize("han", [False, True], ids=["plain", "han"])
@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_modality_trans_matches_jax(han, hard):
    """With HAN in the default soft mode, the HAN takes the hard argmax."""
    jp, pp = _params(lambda i: PG.modality_trans_init(
        i, DIM, depth=2, num_group_tokens=5, num_output_groups=5, use_han=han, han_tokens=6), 6)
    x, g, xo = _x(2, 6, DIM, seed=14), _x(5, DIM, seed=15), _x(2, 6, DIM, seed=16)
    other = xo if han else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        if han and not hard:
            assert _han_margin(jp, x, g, xo) > MIN_MARGIN
        ref, ref_attn, ref_x = JG.modality_trans(
            jp, jnp.asarray(x), jnp.asarray(g), num_heads=8,
            x_other=None if other is None else jnp.asarray(other), hard=hard, gumbel=hard,
            return_attn=True)
    got, attn, got_x = PG.modality_trans(
        pp, torch.from_numpy(x), torch.from_numpy(g), num_heads=8,
        x_other=None if other is None else torch.from_numpy(other), hard=hard, gumbel=hard,
        return_attn=True)
    close(got, ref, G_ATOL, G_RTOL)
    close(got_x, ref_x, G_ATOL, G_RTOL)
    close(attn["soft"], ref_attn["soft"], G_ATOL, G_RTOL)


def test_slim_temporal_attention_matches_jax():
    jp, pp = _params(lambda i: PV.init_slim_temporal_attention(i, 32), 7)
    j_shapes = _shapes(JV.init_slim_temporal_attention(jax.random.PRNGKey(0), 32))
    assert _shapes(jp) == j_shapes
    v, a = _x(3, 10, 32, seed=17), _x(3, 10, 32, seed=18)
    rv, ra = JV.slim_temporal_attention(jp, jnp.asarray(v), jnp.asarray(a))
    for train in (False, True):  # no dropout in training either, as in JAX
        gv, ga = PV.slim_temporal_attention(pp, torch.from_numpy(v), torch.from_numpy(a),
                                            train=train)
        close(gv, rv)
        close(ga, ra)
    assert not np.allclose(gv.numpy(), v)  # the gates act


# ---------------------------------------------------------------------------
# DG-SCT's own AVVP modules
# ---------------------------------------------------------------------------

def test_avvp_adapter_matches_dgsct_golden():
    comp = "avvp_adapter_audio"
    dim, N, odim, M, groups, tokens, use_bn, use_gate, B = ADAPTER_SPECS[comp]
    sd = rebuild_sd(load_census(comp))
    gold = np.load(outputs_path(comp))
    params, state = PTC.convert_adapter(sd, "m", groups=groups)
    cfg = PC.AdapterConfig(reduction_factor=8, num_tokens=tokens, num_conv_group=groups,
                           use_bn=use_bn, use_gate=use_gate)
    x = synth(f"__in__/{comp}/x", (B, dim, N, 1), is_input=True)
    vt = synth(f"__in__/{comp}/vt", (B, odim, M, 1), is_input=True)
    args = (torch.from_numpy(x[:, :, :, 0].transpose(0, 2, 1).copy()),
            torch.from_numpy(vt[:, :, :, 0].transpose(0, 2, 1).copy()))
    out, maps, _ = PAd.adapter(to_torch(params), to_torch(state), *args, cfg, kernels=False)
    close(out, gold["out"][:, :, :, 0].transpose(0, 2, 1), atol=2e-5, rtol=2e-4)
    close(maps, gold["maps"], atol=2e-6, rtol=2e-4)
    # folded for serving, as the engine runs it (K3's plain version on the CPU)
    fp, fs = PAd.fold_eval(to_torch(params), to_torch(state), cfg)
    out, _, _ = PAd.adapter(fp, fs, *args, cfg, kernels=True)
    close(out, gold["out"][:, :, :, 0].transpose(0, 2, 1), atol=2e-5, rtol=2e-4)


def test_slim_temporal_attention_matches_dgsct_golden():
    sd = rebuild_sd(load_census("avvp_slim_temporal_attention"))
    gold = np.load(outputs_path("avvp_slim_temporal_attention"))
    params = to_torch(PTC.convert_slim_temporal_attention(sd, pre="m"))
    f_v = synth("__in__/avvp_ta/f_v", (3, 10, 128), is_input=True)
    f_a = synth("__in__/avvp_ta/f_a", (3, 10, 128), is_input=True)
    v_out, a_out = PV.slim_temporal_attention(params, torch.from_numpy(f_v),
                                              torch.from_numpy(f_a))
    close(v_out, gold["v_out"], atol=5e-5, rtol=2e-4)
    close(a_out, gold["a_out"], atol=5e-5, rtol=2e-4)


@pytest.mark.parametrize("use_han", [False, True], ids=["plain", "han"])
def test_modality_trans_matches_dgsct_golden(use_han):
    comp = "avvp_modality_trans_han" if use_han else "avvp_modality_trans"
    tag = "avvp_mt_han" if use_han else "avvp_mt"
    sd = rebuild_sd(load_census(comp))
    gold = np.load(outputs_path(comp))
    params = to_torch(PTC.convert_modality_trans(sd, "m", depth=3, use_han=use_han))
    x = synth(f"__in__/{tag}/x", (3, 10, 128), is_input=True)
    gt = synth(f"__in__/{tag}/gt", (25, 128), is_input=True)
    xo = synth(f"__in__/{tag}/xo", (3, 10, 128), is_input=True) if use_han else None
    out, _, x_attn = PG.modality_trans(params, torch.from_numpy(x), torch.from_numpy(gt),
                                       num_heads=8,
                                       x_other=None if xo is None else torch.from_numpy(xo))
    close(out, gold["out"], atol=5e-5, rtol=2e-4)
    close(x_attn, gold["x_attn"], atol=5e-5, rtol=2e-4)


# ---------------------------------------------------------------------------
# the whole tiny model
# ---------------------------------------------------------------------------

def test_tiny_avvp_forward_matches_jax(tiny):
    got, ref = _port_forward(tiny), tiny["ref"]
    cfg = tiny["pcfg"]
    B, T, n = 2, cfg.num_frames, cfg.num_classes
    shapes = {"aud_cls_prob": (n, n), "vis_cls_prob": (n, n), "global_prob": (B, n),
              "a_prob": (B, n), "v_prob": (B, n), "a_frame_prob": (B, T, n),
              "v_frame_prob": (B, T, n)}
    assert {k: tuple(v.shape) for k, v in got.items()} == shapes
    for k in OUTPUTS:
        close(got[k], ref[k], msg=k)
    assert float(got["a_frame_prob"].std()) > 1e-3  # the grouping is not degenerate


def test_tiny_avvp_forward_kernels_on_cpu_and_hard_assignment(tiny):
    """kernels=True on CPU tensors takes the plain versions (same outputs);
    with hard unimodal and cross-modal assignment the forward still matches
    JAX's."""
    t = tiny
    with torch.inference_mode():
        on = PV.forward(t["pp"], t["ps"], t["wave"], t["imgs"], t["st"], t["pcfg"], device="cpu")
    for k in OUTPUTS:
        close(on[k], t["ref"][k], msg=k)
    jcfg = dataclasses.replace(t["jcfg"], unimodal_assign="hard", crossmodal_assign="hard")
    pcfg = dataclasses.replace(t["pcfg"], unimodal_assign="hard", crossmodal_assign="hard")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        ref = jax_forward(jcfg)(t["jp"], t["js"], t["wave"], t["imgs"], t["st"])
    got = _port_forward(t, cfg=pcfg)
    for k in OUTPUTS:
        close(got[k], ref[k], msg=f"hard {k}")


def test_entry_points_need_the_card_unless_asked(tiny, monkeypatch):
    t = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PV.init_avvp_model(t["pcfg"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PV.forward(t["pp"], t["ps"], t["wave"], t["imgs"], t["st"], t["pcfg"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax(t["jp"], t["js"], t["pcfg"])


# ---------------------------------------------------------------------------
# int8: calibrate_avvp and the int8 forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated(tiny):
    t = tiny
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        j = JQ.calibrate_avvp(t["jp"], t["js"], t["jcfg"], jnp.asarray(t["wave"]),
                              jnp.asarray(t["imgs"]), jnp.asarray(t["st"]), min_dim=MIN_DIM)
    p = PQ.calibrate_avvp(t["pp"], t["ps"], t["pcfg"], t["wave"], t["imgs"], t["st"],
                          min_dim=MIN_DIM, device="cpu")
    return j, p


def test_calibrate_avvp_matches_jax(calibrated):
    j, p = calibrated
    assert sorted(p) == sorted(j) and len(p) > 10
    for q in j:
        np.testing.assert_allclose(p[q], j[q], rtol=1e-4, err_msg=f"qid {q}")


def _spread_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-3)


def test_int8_forward_matches_jax(tiny, calibrated):
    """The tiny int8-towers forward (JAX's static scales on both sides)
    within half of JAX's int8-against-float drift, per output."""
    t = tiny
    scales = calibrated[0]
    jq = JQ.quantize_eval_params(t["jp"], min_dim=MIN_DIM, act_scales=scales)
    pq = PQ.quantize_eval_params(t["pp"], min_dim=MIN_DIM, act_scales=scales)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        ref = jax.tree_util.tree_map(np.asarray, t["fwd"](jq, t["js"], t["wave"], t["imgs"],
                                                          t["st"]))
    got = _port_forward(t, pq)
    for k in ("global_prob", "a_prob", "v_prob", "a_frame_prob", "v_frame_prob"):
        err, drift = _spread_err(got[k].numpy(), ref[k]), _spread_err(ref[k], t["ref"][k])
        assert drift > 1e-4, k  # the towers ran in int8
        assert err < DRIFT_SHARE * drift, (k, err, drift)
