"""The port's AVS training (dg_sct_tpu_torch: the S4 and MS3 losses, the
train branches of the AVS head, TPAVI and forward, remat, the eval step,
the train-state bundle, `avs_main`) against the JAX package on the tiny AVS
model, float32, JAX at matmul precision "highest", the same weights
carried across by `from_jax`. Each JAX program is compiled once for the
module. The train steps and gradients are held against JAX's
`make_train_step` in tests/test_torch_avs_train_s4.py and
tests/test_torch_avs_train_ms3.py (tests/avs_train_parity.py).

Tolerances: each loss rtol 1e-5 against the JAX function on seeded inputs;
the head's train branch, TPAVI in train mode and the whole train forward
(no generator, BN on the batch's statistics) atol 1e-4 / rtol 1e-4, outputs
and new state. Remat "full", "dots" and "none" give gradients within 1e-5
with SpecAugment, drop_path and dropout on. JAX's eval step on the port's
saved train state gives the port's masks within 1e-4."""
import contextlib
import dataclasses
import io
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.models import avs as JAvs
from dg_sct_tpu.models import interleave as JI
from dg_sct_tpu.models import tpavi as JTP
from dg_sct_tpu.models.heads import avs as JH
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.train import avs_train as JT
from dg_sct_tpu.utils import checkpoint as JCk
from dg_sct_tpu_torch.configs import TrainConfig as PTrainConfig
from dg_sct_tpu_torch.models import avs as PAvs
from dg_sct_tpu_torch.models import tpavi as PTP
from dg_sct_tpu_torch.models.heads import avs as PH
from dg_sct_tpu_torch.ops.basic import apply_keep_mask
from dg_sct_tpu_torch.train import avs_main as PMain
from dg_sct_tpu_torch.train import avs_train as PT
from dg_sct_tpu_torch.utils import checkpoint as PCk
from dg_sct_tpu_torch.utils.tree import tree_leaves, tree_paths
from dg_sct_tpu_torch.weights import from_jax
import media_tree
from avs_train_parity import (B, TOL, close_trees, few_threads, make_model, port, task_batch,
                              train_cfgs)
from torch_port_helpers import to_numpy, to_torch

LOSS_RTOL = 1e-5
REMAT_TOL = dict(atol=1e-5, rtol=1e-5)
TINY_WAVE = 3200     # the tiny frontend's samples a frame


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    yield from few_threads()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    return make_model()


@pytest.fixture(scope="module")
def jax_fwd(model):
    """JAX's train forward (rng None) on the first batch, and JAX's eval step."""
    jcfg, _, jp, js, batches = model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        mp.setattr(JI, "REMAT_POLICY", "full")
        fwd = jax.jit(lambda p, s, i, w: JAvs.forward(p, s, i, w, jcfg, train=True))
        out, new_state = fwd(jp, js, batches[0]["image"], batches[0]["wave"])
        yield {"out": to_numpy(out), "state": to_numpy(new_state),
               "eval_step": JT.make_eval_step(jcfg)}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs(seed=0, n=2, T=3, S=16):
    """Seeded logits spread around 0 (so that a threshold at 0.5 splits the
    pooled probabilities), masks, and per-stage visual maps and audio
    features at the grids 8, 4, 2, 1 (stage 2 without an audio feature)."""
    rs = np.random.RandomState(seed)
    pred = (2.0 * rs.randn(n * T, S, S, 1)).astype(np.float32)
    gt_all = (rs.rand(n * T, S, S, 1) > 0.6).astype(np.float32)
    C = 6
    v_maps = [rs.randn(n * T, g, g, C).astype(np.float32) for g in (8, 4, 2, 1)]
    a_fea = [rs.randn(n, T, C).astype(np.float32) for _ in range(4)]
    a_fea[2] = None
    return pred, gt_all, v_maps, a_fea, T


def _loss_cases():
    pred, gt_all, v_maps, a_fea, T = _loss_inputs()
    gt_first = gt_all[::T]
    out = {"pred": pred, "feature_map_list": v_maps, "a_fea_list": a_fea}
    stages = (0, 1, 3)
    return {
        "f1_bce": lambda m: m.f1_iou_bce_loss(pred, gt_first, T),
        "f5_bce": lambda m: m.f5_iou_bce_loss(pred, gt_all),
        "simm": lambda m: m.masked_av_simm_loss(pred, a_fea, v_maps, stages),
        "kl": lambda m: m.masked_av_kl_loss(pred, a_fea, v_maps, stages),
        "kl_unnormed": lambda m: m.masked_av_kl_loss(pred, a_fea, v_maps, stages,
                                                     norm_fea=False),
        "s4_composition": lambda m: m.iou_semantic_aware_loss(
            out, gt_first, lambda_1=0.3, count_stages=stages, sa_loss_flag=True, num_frames=T),
        "s4_default": lambda m: m.iou_semantic_aware_loss(out, gt_first, num_frames=T),
        "ms3_composition": lambda m: m.ms3_loss(out, gt_all),
    }


def _as_torch(x):
    if isinstance(x, dict):
        return {k: _as_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_as_torch(v) for v in x]
    return x if x is None or isinstance(x, (int, float)) else torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("name", sorted(_loss_cases()))
def test_losses_match_jax(name):
    case = _loss_cases()[name]

    class Torch:  # the port's losses called on tensors
        def __getattr__(self, fn):
            f = getattr(PT, fn)
            return lambda *a, **kw: f(*_as_torch(list(a)), **kw)

    got, ref = float(case(Torch())), float(case(JT))
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert np.isfinite(ref) and ref != 0.0


def test_simm_threshold_bites():
    """The similarity loss's 0.5 threshold keeps part of each pooled map:
    logits shifted by a constant move it."""
    pred, _, v_maps, a_fea, _ = _loss_inputs()
    pooled = 1 / (1 + np.exp(-JT.adaptive_avg_pool(jnp.asarray(pred), 4, 4)))
    assert 0.1 < float(np.mean(np.asarray(pooled) > 0.5)) < 0.9
    losses = [float(PT.masked_av_simm_loss(torch.from_numpy(pred + d), _as_torch(a_fea),
                                           _as_torch(v_maps), (0, 1, 3))) for d in (0.0, 0.5)]
    assert losses[0] != losses[1]


# ---------------------------------------------------------------------------
# the train branches of the head, TPAVI and the forward
# ---------------------------------------------------------------------------

def _head_inputs(cfg, seed=0):
    rs = np.random.RandomState(seed)
    T, C = cfg.num_frames, cfg.channel
    maps = [rs.randn(B * T, s, s, C).astype(np.float32) for s in cfg.scale_sizes]
    return maps, rs.randn(B, T, C // 2).astype(np.float32)


def test_head_train_branch_matches_jax(model, monkeypatch):
    """Train mode with dropout: the port's head fed the masks JAX drew
    (fold_in(rng, i) for scale i) gives JAX's maps and audio; the port draws
    each from the generator it is given, and the encoders draw none."""
    jcfg, pcfg, jp, _, _ = model
    maps, audio = _head_inputs(jcfg)
    key = jax.random.PRNGKey(4)
    ref_maps, ref_audio = JH.avs_temporal_attention(
        jax.tree_util.tree_map(jnp.asarray, jp["temporal_attn"]), [jnp.asarray(m) for m in maps],
        jnp.asarray(audio), num_frames=jcfg.num_frames, train=True, rng=key)
    masks = [np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i), 1.0 - PH.ave_heads.V_DROP,
                                             (B, jcfg.num_frames, jcfg.channel)))
             for i in range(PH.NUM_SCALES)]
    drawn = []

    def fed(gen, x, rate, train):
        assert gen is not None and train and rate == PH.ave_heads.V_DROP
        drawn.append(gen)
        return apply_keep_mask(x, torch.from_numpy(np.array(masks[len(drawn) - 1])), rate)

    monkeypatch.setattr(PH, "dropout", fed)
    gen = torch.Generator().manual_seed(0)
    got_maps, got_audio = PH.avs_temporal_attention(
        to_torch(jp["temporal_attn"]), _as_torch(maps), torch.from_numpy(audio),
        num_frames=jcfg.num_frames, train=True, gen=gen)
    assert len(drawn) == PH.NUM_SCALES and all(g is gen for g in drawn)
    for g, r in zip(got_maps, ref_maps):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(got_audio.numpy(), np.asarray(ref_audio), **TOL)
    assert any(not m.all() for m in masks)


def test_head_train_without_generator_is_eval(model):
    """No generator, no draw: train mode computes the eval maps, as JAX's
    head does without an rng."""
    jcfg, _, jp, _, _ = model
    maps, audio = _head_inputs(jcfg, seed=1)
    p = to_torch(jp["temporal_attn"])
    train = PH.avs_temporal_attention(p, _as_torch(maps), torch.from_numpy(audio),
                                      num_frames=jcfg.num_frames, train=True)
    ref = JH.avs_temporal_attention(jax.tree_util.tree_map(jnp.asarray, jp["temporal_attn"]),
                                    [jnp.asarray(m) for m in maps], jnp.asarray(audio),
                                    num_frames=jcfg.num_frames, train=True, rng=None)
    for g, r in zip(train[0] + [train[1]], list(ref[0]) + [ref[1]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("with_audio", [True, False])
def test_tpavi_train_matches_jax(model, with_audio):
    """TPAVI on the batch's statistics over (B, T, H, W): output, aligned
    audio and the new BN running state."""
    _, _, jp, js, _ = model
    rs = np.random.RandomState(5)
    x = rs.randn(B, 2, 4, 4, 32).astype(np.float32) * 2.0 + 0.5
    audio = rs.randn(B, 2, 16).astype(np.float32) if with_audio else None
    tp, ts = jp["tpavi"]["tpavi_b1"], js["tpavi"]["tpavi_b1"]
    z, a, st = JTP.tpavi(jax.tree_util.tree_map(jnp.asarray, tp),
                         jax.tree_util.tree_map(jnp.asarray, ts), jnp.asarray(x),
                         None if audio is None else jnp.asarray(audio), train=True)
    gz, ga, gst = PTP.tpavi(to_torch(tp), to_torch(ts), torch.from_numpy(x),
                            None if audio is None else torch.from_numpy(audio), train=True)
    np.testing.assert_allclose(gz.numpy(), np.asarray(z), **TOL)
    if with_audio:
        np.testing.assert_allclose(ga.numpy(), np.asarray(a), **TOL)
    close_trees(gst, to_numpy(st), **TOL)
    assert int(gst["bn"]["count"]) == int(ts["bn"]["count"]) + 1
    assert not np.allclose(gst["bn"]["mean"].numpy(), ts["bn"]["mean"])


def test_train_forward_matches_jax(model, jax_fwd):
    """`avs.forward(train=True, gen=None)` against JAX's train=True, rng=None:
    pred, feature maps, a_fea_list and the new state (bn0, adapters, each
    TPAVI BN); the eval form still returns the outputs alone."""
    pcfg, pp, ps, batches = port(model)
    b = batches[0]
    out, new_state = PAvs.forward(pp, ps, b["image"], b["wave"], pcfg, train=True,
                                  device="cpu")
    ref = jax_fwd["out"]
    np.testing.assert_allclose(out["pred"].detach().numpy(), ref["pred"], **TOL)
    for g, r in zip(out["feature_map_list"], ref["feature_map_list"]):
        np.testing.assert_allclose(g.detach().numpy(), r, **TOL)
    for g, r in zip(out["a_fea_list"], ref["a_fea_list"]):
        assert (g is None) == (r is None)
        if g is not None:
            np.testing.assert_allclose(g.detach().numpy(), r, **TOL)
    close_trees(new_state, jax_fwd["state"], **TOL)
    assert set(new_state["tpavi"]) == {f"tpavi_b{i + 1}" for i in pcfg.tpavi_stages}
    counts = {int(c) for p, c in tree_paths(new_state) if p[-1] == "count"}
    assert counts == {1}
    with torch.inference_mode():
        ev = PAvs.forward(pp, ps, b["image"], b["wave"], pcfg, device="cpu", kernels=False)
    assert set(ev) == {"pred", "feature_map_list", "a_fea_list"}


# ---------------------------------------------------------------------------
# remat and the saved train state
# ---------------------------------------------------------------------------

def _remat_grads(pcfg, pp, ps, batch, policy, seed):
    tr, fr = PT.partition_params(pp)
    opt = PT.make_optimizer(tr, train_cfgs(accum=2)[1], steps_per_epoch=1)
    step = PT.make_train_step(pcfg, opt, task="s4", device="cpu", remat_policy=policy)
    _, state, opt_state, m = step(tr, fr, ps, opt.init(tr), batch,
                                  torch.Generator().manual_seed(seed))
    return opt_state["acc"], state, float(m["loss"])


def test_remat_policies_give_equal_gradients(model):
    """drop_path at 0.2 / 0.1, SpecAugment and the head's dropout from one
    seeded generator: remat "full" and "dots" give the gradients and new
    state of "none"."""
    _, pcfg, jp, js, batches = model
    pcfg = dataclasses.replace(pcfg, swin=dataclasses.replace(pcfg.swin, drop_path_rate=0.2),
                               htsat=dataclasses.replace(pcfg.htsat, drop_path_rate=0.1))
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    batch = task_batch(batches[0], "s4")
    ref, ref_state, ref_loss = _remat_grads(pcfg, pp, ps, batch, "none", seed=3)
    assert _remat_grads(pcfg, pp, ps, batch, "none", seed=4)[2] != ref_loss  # draws matter
    for policy in ("full", "dots"):
        got, state, loss = _remat_grads(pcfg, pp, ps, batch, policy, seed=3)
        np.testing.assert_allclose(loss, ref_loss, **REMAT_TOL)
        for (path, g), r in zip(tree_paths(got), tree_leaves(ref)):
            np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=f"{policy} {path}",
                                       **REMAT_TOL)
        for g, r in zip(tree_leaves(state), tree_leaves(ref_state)):
            np.testing.assert_allclose(g.numpy(), r.numpy(), **REMAT_TOL)


def test_saved_state_read_by_jax_and_resume(model, jax_fwd, tmp_path):
    """Two S4 steps with a generator, saved as `s4_best.npz`: JAX's
    load_params_and_state and restore_structure read it, and JAX's eval step
    on it gives the port's masks; loading it in the port and taking a third
    step equals three straight, bit for bit."""
    jcfg, pcfg, jp, js, batches = model
    _, pp, ps, _ = port(model)
    tr, fr = PT.partition_params(pp)
    opt = PT.make_optimizer(tr, train_cfgs()[1], steps_per_epoch=1)
    step = PT.make_train_step(pcfg, opt, task="s4", device="cpu")

    def run(tr, state, opt_state, gen, steps):
        for i in steps:
            tr, state, opt_state, m = step(tr, fr, state, opt_state,
                                           task_batch(batches[i % 2], "s4"), gen)
        return tr, state, opt_state, m

    gen = torch.Generator().manual_seed(11)
    straight = run(tr, ps, opt.init(tr), gen, range(3))
    gen = torch.Generator().manual_seed(11)
    tr2, st2, os2, _ = run(tr, ps, opt.init(tr), gen, range(2))
    path = str(tmp_path / "s4_best.npz")
    PCk.save_train_state(path, params=PT.merge_params(tr2, fr), state=st2, opt_state=os2,
                         rng_state=gen.get_state(), step=2, metadata={"epoch": 1})

    lp, ls = JCk.load_params_and_state(path)
    jparams, jstate = JCk.restore_structure(jp, lp), JCk.restore_structure(js, ls)
    jtr, jfr = JT.partition_params(jparams)
    feed = {k: batches[1][k] for k in ("image", "wave")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        ref = np.asarray(jax_fwd["eval_step"](jtr, jfr, jstate, feed))
    got = PT.make_eval_step(pcfg, device="cpu")(tr2, fr, st2, feed)
    assert got.shape == ref.shape == (B * jcfg.num_frames, jcfg.mask_size, jcfg.mask_size, 1)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the bundle drops the AVS adapters' leafless states; from_jax (the engine's
    # loader) takes it as it is
    assert "adapters" not in ls
    served = from_jax(*PCk.load_params_and_state(path), pcfg, device="cpu")
    for a, b in zip(tree_leaves(served), tree_leaves((PT.merge_params(tr2, fr), st2))):
        assert torch.equal(a, b)

    lp, ls, lo, rng_state, n = PCk.load_train_state(path, opt_state_template=opt.init(tr))
    assert n == 2 and lo["gradient_step"] == 2
    params = PCk.restore_structure(pp, lp)
    rtr, rfr = PT.partition_params(params)
    resumed = run(rtr, PCk.restore_structure(ps, ls), lo,
                  torch.Generator().set_state(rng_state), range(2, 3))
    for a, b in zip(tree_leaves(resumed[:3]), tree_leaves(straight[:3])):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert float(resumed[3]["loss"]) == float(straight[3]["loss"])


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def write_tree(root, cfg, *, mask_frames):
    """Train and test splits of 2 videos each in the AVSBench layout."""
    for split in ("train", "test"):
        media_tree.make_avs_tree(root, [("guitar", f"v{split}0"), ("drum", f"v{split}1")],
                                 split=split, n_frames=cfg.num_frames, img_size=cfg.mask_size,
                                 wave_samples=cfg.num_frames * TINY_WAVE,
                                 mask_frames=mask_frames)
    return root


def run_main(argv, cfg):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        result = PMain.main(argv + ["--device", "cpu"], cfg=cfg)
    return result, log.getvalue().splitlines()


def check_result(result):
    assert result is not None
    assert 0.0 <= result["miou"] <= 1.0 and 0.0 <= result["f_score"] <= 1.0


def test_avs_main_smoke(model):
    """`--mode smoke` on the tiny config: finite losses, then one eval."""
    pcfg = model[1]
    result, lines = run_main(["--mode", "smoke", "--batch-size", "2", "--synthetic-steps",
                              "2"], pcfg)
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines if ln.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert any(ln.startswith("smoke eval: mIoU=") for ln in lines)
    check_result(result)


def test_avs_main_s4_train_and_eval(model, tmp_path):
    """S4 `--mode train` over a tree on disk: `s4_best.npz` (a train state),
    the metrics log and the run snapshot, the test report; then `--mode eval
    --save-pred-mask` from that state writes every frame's PNG and gives the
    same report."""
    pcfg = model[1]
    root = write_tree(str(tmp_path), pcfg, mask_frames=pcfg.num_frames)
    save = os.path.join(root, "ckpt")
    result, lines = run_main(["--mode", "train", "--task", "s4", "--epochs", "1",
                              "--batch-size", "2", "--root", root, "--save-dir", save], pcfg)
    check_result(result)
    assert any(ln.startswith("test mIoU:") for ln in lines)
    best = os.path.join(save, "s4_best.npz")
    assert os.path.exists(best) and os.path.exists(best + ".meta.json")
    assert os.path.exists(os.path.join(save, "avs_s4.metrics.jsonl"))
    assert os.path.exists(os.path.join(save, "run_meta.json"))
    _, _, opt_state, _, n = PCk.load_train_state(best)
    assert n == 1 and int(opt_state["gradient_step"]) == 1

    out = os.path.join(root, "eval")
    got, _ = run_main(["--mode", "eval", "--root", root, "--ckpt", best, "--batch-size", "2",
                       "--save-dir", out, "--save-pred-mask"], pcfg)
    assert got["miou"] == pytest.approx(result["miou"], abs=1e-6)
    assert got["f_score"] == pytest.approx(result["f_score"], abs=1e-6)
    pngs = sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, fs in os.walk(out) for f in fs if f.endswith(".png"))
    assert pngs == sorted(os.path.join("pred_masks", cat, vid, f"{vid}_{t}.png")
                          for cat, vid in (("guitar", "vtest0"), ("drum", "vtest1"))
                          for t in range(pcfg.num_frames))


def test_avs_main_ms3_train(model, tmp_path):
    """MS3 `--mode train` (every frame's mask, the KL term on): finite
    losses, `ms3_best.npz` and the test report."""
    pcfg = model[1]
    root = write_tree(str(tmp_path), pcfg, mask_frames=pcfg.num_frames)
    save = os.path.join(root, "ckpt")
    result, lines = run_main(["--mode", "train", "--task", "ms3", "--epochs", "1",
                              "--batch-size", "2", "--log-every", "1", "--root", root,
                              "--save-dir", save], pcfg)
    check_result(result)
    losses = [float(ln.split("loss=")[1]) for ln in lines if "loss=" in ln]
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert os.path.exists(os.path.join(save, "ms3_best.npz"))


def test_entry_points_need_the_card_unless_asked(model, monkeypatch):
    pcfg = model[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = PT.make_optimizer({}, PTrainConfig(), steps_per_epoch=1)
    for call in (lambda: PT.make_train_step(pcfg, opt),
                 lambda: PT.make_eval_step(pcfg),
                 lambda: PMain.main(["--mode", "smoke"], cfg=pcfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert callable(PT.make_eval_step(pcfg, device="cpu"))
