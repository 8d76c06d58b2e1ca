"""The port's AVVP training (dg_sct_tpu_torch.train.avvp_train, .avvp_main)
on the CPU: the loss and its gradients against the JAX package's on seeded
outputs (rtol 1e-5); the HAN's Gumbel noise and the towers' draws from the
step's generator (a step with one differs from a step without and stays
finite); the eval step; and the entry point's smoke, train and eval modes
on the tiny model and an on-disk LLP tree. The train step itself is held
against JAX's in tests/test_torch_avvp_train_steps.py."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.train import avvp_train as JT
from dg_sct_tpu_torch.configs import TrainConfig
from dg_sct_tpu_torch.data import avvp as PD
from dg_sct_tpu_torch.models import avvp as PV
from dg_sct_tpu_torch.train import avvp_main
from dg_sct_tpu_torch.train import avvp_train as PT
from dg_sct_tpu_torch.utils.tree import tree_leaves
from dg_sct_tpu_torch.weights import from_jax
import media_tree
from test_torch_avvp import (few_torch_threads, port_avvp_cfg, scramble_avvp,  # noqa: F401
                             tiny_avvp_cfg)
from torch_port_helpers import to_numpy

LOSS_KEYS = ("global_prob", "a_prob", "v_prob", "aud_cls_prob", "vis_cls_prob")


def _outputs(seed):
    rs = np.random.RandomState(seed)
    out = {"global_prob": rs.rand(2, 25), "a_prob": rs.rand(2, 25), "v_prob": rs.rand(2, 25),
           "aud_cls_prob": rs.randn(25, 25), "vis_cls_prob": rs.randn(25, 25)}
    out["a_prob"][0, :3] = (0.0, 1.0, 1e-9)  # the clamp at both ends
    target = (rs.rand(2, 25) > 0.7).astype(np.float32)
    return {k: v.astype(np.float32) for k, v in out.items()}, target


@pytest.mark.parametrize("seed", [0, 1])
def test_avvp_loss_and_gradients_match_jax(seed):
    out, target = _outputs(seed)
    ref, ref_g = jax.value_and_grad(lambda o: JT.avvp_loss(o, jnp.asarray(target)))(
        {k: jnp.asarray(v) for k, v in out.items()})
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in out.items()}
    loss = PT.avvp_loss(leaves, torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(ref_g[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    p = torch.from_numpy(out["global_prob"])
    t = torch.from_numpy(target)
    np.testing.assert_allclose(float(PT.bce_probs(p, t)),
                               float(torch.nn.functional.binary_cross_entropy(p, t)), rtol=1e-5)


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_avvp_cfg()
    pcfg = port_avvp_cfg(jcfg)
    jp, js = scramble_avvp(*(to_numpy(t) for t in PV.init_avvp_model(pcfg, device="cpu")))
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    batch = PD.synthetic_batch(2, img_size=pcfg.swin.img_size, seed=5, num_frames=pcfg.num_frames,
                               sr=pcfg.htsat.frontend.clip_samples)
    return pcfg, pp, ps, batch


def test_heads_draw_gumbel_noise_from_the_generator(model):
    """In training with a generator, the HAN (hard and Gumbel under the
    default soft assignment) draws noise: the outputs follow the seed and
    differ from the noiseless ones; without one, or in eval, they are the
    noiseless ones."""
    pcfg, pp, _, _ = model
    rs = np.random.RandomState(3)
    T = pcfg.num_frames
    f_v = torch.from_numpy(rs.randn(2, T, pcfg.swin.num_features).astype(np.float32))
    f_a = torch.from_numpy(rs.randn(2, T, pcfg.htsat.num_features).astype(np.float32))
    st = torch.from_numpy(rs.randn(2, T, 512).astype(np.float32))
    run = lambda **kw: PV.heads(pp, f_v, f_a, st, pcfg, **kw)["a_prob"]
    base = run()
    assert torch.equal(run(train=True), base)
    a = run(train=True, gen=torch.Generator().manual_seed(0))
    b = run(train=True, gen=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, base)
    # the visual grouping (soft, no HAN) draws none
    v = lambda **kw: PV.heads(pp, f_v, f_a, st, pcfg, **kw)["v_prob"]
    assert torch.equal(v(train=True, gen=torch.Generator().manual_seed(0)), v())


def test_step_with_a_generator_differs_and_stays_finite(model):
    pcfg, pp, ps, batch = model
    tr, fr = PT.partition_params(pp)
    opt = PT.make_optimizer(tr, TrainConfig(accum_steps=1), steps_per_epoch=1)
    step = PT.make_train_step(pcfg, opt, device="cpu")
    plain = step(tr, fr, ps, opt.init(tr), batch)
    drawn = step(tr, fr, ps, opt.init(tr), batch, torch.Generator().manual_seed(1))
    again = step(tr, fr, ps, opt.init(tr), batch, torch.Generator().manual_seed(1))
    lp, ld = float(plain[3]["loss"]), float(drawn[3]["loss"])
    assert np.isfinite(lp) and np.isfinite(ld) and lp != ld
    assert float(again[3]["loss"]) == ld
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(drawn[0]))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(plain[0]),
                                                      tree_leaves(drawn[0])))
    # the step changed nothing it was given
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tr), tree_leaves(
        PT.partition_params(pp)[0])))


def test_eval_step_is_the_eval_forward(model):
    pcfg, pp, ps, batch = model
    tr, fr = PT.partition_params(pp)
    out = PT.make_eval_step(pcfg, device="cpu")(tr, fr, ps, batch)
    with torch.inference_mode():
        ref = PV.forward(pp, ps, batch["wave"], batch["image"], batch["video_st"], pcfg,
                         device="cpu")
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


def test_main_smoke(capsys):
    scores = avvp_main.main(["--mode", "smoke", "--device", "cpu", "--batch-size", "2",
                             "--synthetic-steps", "2"], cfg=port_avvp_cfg(tiny_avvp_cfg()))
    text = capsys.readouterr().out
    assert "step 1: loss=" in text and "smoke eval:" in text
    assert set(scores) == {"seg_a", "seg_v", "seg", "seg_av", "evt_a", "evt_v", "evt", "evt_av"}


def test_main_train_and_eval(tmp_path, capsys):
    """One epoch over an on-disk LLP tree: val F1, MGN_Net.npz saved, the
    test report with the best weights, the metrics stream; then --mode eval
    from the checkpoint gives the same test report."""
    cfg = port_avvp_cfg(tiny_avvp_cfg())
    root = str(tmp_path)
    t = media_tree.make_llp_tree(root, ["aaaaaaaaaaa_0", "bbbbbbbbbbb_1", "ccccccccccc_2"],
                                 n_frames=3, img_size=64,
                                 wave_samples=2 * cfg.htsat.frontend.clip_samples)
    data = ["--label-test", os.path.join(root, "AVVP_test_pd.csv"), "--eval-csv-dir", root,
            "--frames", t["frames"], "--audio", t["audio"], "--st", t["st"], "--device", "cpu"]
    save = os.path.join(root, "ckpt")
    summary = avvp_main.main(["--mode", "train", "--epochs", "1", "--batch-size", "2",
                              "--label-train", os.path.join(root, "AVVP_train.csv"),
                              "--label-val", os.path.join(root, "AVVP_val_pd.csv"),
                              "--save-dir", save] + data, cfg=cfg)
    assert set(summary) >= {"segment_type_avg", "event_type_avg"}
    assert all(0.0 <= v <= 100.0 for v in summary.values())
    best = os.path.join(save, "MGN_Net.npz")
    assert os.path.exists(best)
    with open(best + ".meta.json") as f:
        assert json.load(f)["epoch"] == 1
    with open(os.path.join(save, "avvp.metrics.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    assert events[0]["event"] == "config"
    assert any(e["event"] == "scalars" and "val/segment_type_avg" in e for e in events)
    assert any(e["event"] == "scalars" and "test/segment_type_avg" in e for e in events)
    assert "saved best" in capsys.readouterr().out
    again = avvp_main.main(["--mode", "eval", "--ckpt", best] + data, cfg=cfg)
    assert again == pytest.approx(summary)
    with pytest.raises(SystemExit, match="--label-test"):
        avvp_main.main(["--mode", "eval", "--device", "cpu"], cfg=cfg)
