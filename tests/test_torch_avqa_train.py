"""The port's AVQA training (dg_sct_tpu_torch.train.avqa_train, .avqa_main)
on the CPU: the loss and its gradients against the JAX package's on seeded
outputs (rtol 1e-5); stage 1's labels and two stage-1 train steps against
JAX's `make_stage1_steps` (plain Adam; loss, new bn0 state and updated
heads at atol 1e-4 / rtol 1e-4, the towers untouched); `transfer_stage1`
against JAX's; the heads' dropout from the step's generator; the eval step;
and the entry point's smoke, train and eval modes for both stages on the
tiny model and an on-disk MUSIC-AVQA tree. The stage-2 train step is held
against JAX's in tests/test_torch_avqa_train_steps.py."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.train import avqa_main as JM
from dg_sct_tpu.train import avqa_train as JT
from dg_sct_tpu_torch.configs import TrainConfig
from dg_sct_tpu_torch.data import avqa as PD
from dg_sct_tpu_torch.models import avqa as PA
from dg_sct_tpu_torch.models import avqa_grounding as PG
from dg_sct_tpu_torch.train import avqa_main
from dg_sct_tpu_torch.train import avqa_train as PT
from dg_sct_tpu_torch.utils import checkpoint as PCK
from dg_sct_tpu_torch.utils.tree import tree_leaves, tree_paths
from dg_sct_tpu_torch.weights import from_jax
import media_tree
from avs_train_parity import close_trees
from test_torch_avqa import few_torch_threads, port_avqa_cfg, scramble_avqa  # noqa: F401
from test_torch_avqa import tiny_avqa4_cfg
from torch_port_helpers import to_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
LR = 1e-4            # the AVQA recipe's, both stages
HEADS = ("fc_a1", "fc_a2", "fc_gl", "fc1", "fc2", "fc3", "fc4")


def _outputs(seed, B=3, T=2):
    rs = np.random.RandomState(seed)
    out = {"out_qa": rs.randn(B, 42), "out_match_posi": rs.randn(B * T, 2),
           "out_match_nega": rs.randn(B * T, 2)}
    return ({k: v.astype(np.float32) for k, v in out.items()},
            rs.randint(0, 42, B).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_avqa_loss_and_gradients_match_jax(seed):
    out, answer = _outputs(seed)
    ref, ref_g = jax.value_and_grad(lambda o: JT.avqa_loss(o, jnp.asarray(answer)))(
        {k: jnp.asarray(v) for k, v in out.items()})
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in out.items()}
    loss = PT.avqa_loss(leaves, torch.from_numpy(answer))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    for k in out:
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(ref_g[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(PT.match_labels(3, "cpu").numpy(), [1, 1, 1, 0, 0, 0])


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_avqa4_cfg()
    pcfg = port_avqa_cfg(jcfg)
    jp, js = (to_numpy(t) for t in PA.init_avqa_model(pcfg, seed=6, device="cpu"))
    jp = scramble_avqa(jp, seed=6)
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    batch = PD.synthetic_batch(2, img_size=pcfg.swin.img_size, num_frames=pcfg.num_frames,
                               seed=5, sr=pcfg.htsat.frontend.clip_samples)
    return jcfg, pcfg, jp, js, pp, ps, batch


# ---------------------------------------------------------------------------
# stage 1
# ---------------------------------------------------------------------------

def test_stage1_labels_match_jax():
    for B in (1, 2, 5):
        np.testing.assert_array_equal(avqa_main.stage1_labels(B, "cpu").numpy(),
                                      np.tile([1, 0], B))


def test_stage1_steps_match_jax(model):
    """Two stage-1 steps with plain Adam at the recipe's lr, no generator on
    either side (JAX's rng=None draws no SpecAugment): loss, accuracy, bn0's
    new state and the heads after each; the towers stay as they were; the
    eval step's loss and accuracy."""
    jcfg, pcfg, *_, batch = model
    jp, js = (to_numpy(t) for t in PG.init_grounding_model(pcfg, seed=7, device="cpu"))
    pp, ps = from_jax(jp, js, pcfg, device="cpu", grounding=True)
    batches = [batch, {**batch, "visual_posi": batch["visual_nega"],
                       "visual_nega": batch["visual_posi"]}]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        tx = optax.adam(LR)
        jtr, jfr = JT.partition_params(jax.tree_util.tree_map(jnp.asarray, jp))
        jstep, jeval = JM.make_stage1_steps(jcfg, tx)
        jopt, jst, ref = tx.init(jtr), jax.tree_util.tree_map(jnp.asarray, js), []
        for b in batches:
            jtr, jst, jopt, m = jstep(jtr, jfr, jst, jopt, b, None)
            ref.append((to_numpy(jtr), to_numpy(jst), {k: float(v) for k, v in m.items()}))
        jev = {k: float(v) for k, v in jeval(jtr, jfr, jst, batches[0]).items()}
    tr, fr = PT.partition_params(pp)
    assert sorted(tr) == sorted(HEADS) and sorted(fr) == ["htsat", "swin"]
    opt = avqa_main.plain_adam(LR)
    step, estep = avqa_main.make_stage1_steps(pcfg, opt, device="cpu")
    opt_state, state = opt.init(tr), ps
    for b, (rtr, rst, rm) in zip(batches, ref):
        tr, state, opt_state, m = step(tr, fr, state, opt_state, b)
        np.testing.assert_allclose(float(m["loss"]), rm["loss"], **TOL)
        assert float(m["acc"]) == pytest.approx(rm["acc"])
        close_trees(state, rst, **TOL)
        close_trees(tr, rtr, **TOL)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(fr),
                                                  tree_leaves(PT.partition_params(pp)[1])))
    ev = estep(tr, fr, state, batches[0])
    np.testing.assert_allclose(float(ev["loss"]), jev["loss"], **TOL)
    assert float(ev["acc"]) == pytest.approx(jev["acc"])


def test_transfer_stage1_matches_jax(model):
    """The shared heads come over (onto the stage-2 leaves' device and type),
    everything else stays."""
    _, pcfg, jp, *_ = model
    s1, _ = PG.init_grounding_model(pcfg, seed=9, device="cpu")
    s1_np = to_numpy(s1)
    got = avqa_main.transfer_stage1(from_jax(jp, model[3], pcfg, device="cpu")[0], s1_np)
    ref = JM.transfer_stage1(jp, s1_np)
    assert sorted(got) == sorted(ref)
    for k in ref:
        close_trees(got[k], ref[k], atol=0, rtol=0)
    assert all(isinstance(t, torch.Tensor) for _, t in tree_paths(got))


# ---------------------------------------------------------------------------
# stage 2
# ---------------------------------------------------------------------------

def test_step_draws_dropout_from_the_generator(model):
    """A stage-2 step with a generator (SpecAugment and the heads' dropout)
    differs from one without, follows the seed and stays finite; the step
    changes nothing it was given."""
    _, pcfg, _, _, pp, ps, batch = model
    tr, fr = PT.partition_params(pp)
    opt = PT.make_optimizer(tr, TrainConfig(accum_steps=1, lr=LR), steps_per_epoch=1)
    step = PT.make_train_step(pcfg, opt, device="cpu")
    plain = step(tr, fr, ps, opt.init(tr), batch)
    drawn = step(tr, fr, ps, opt.init(tr), batch, torch.Generator().manual_seed(1))
    again = step(tr, fr, ps, opt.init(tr), batch, torch.Generator().manual_seed(1))
    lp, ld = float(plain[3]["loss"]), float(drawn[3]["loss"])
    assert np.isfinite(lp) and np.isfinite(ld) and lp != ld
    assert float(again[3]["loss"]) == ld and 0.0 <= float(drawn[3]["qa_acc"]) <= 1.0
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(drawn[0]))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tr), tree_leaves(
        PT.partition_params(pp)[0])))
    # the heads' dropout alone moves the answer
    f_a = torch.randn(2, pcfg.num_frames, pcfg.htsat.num_features)
    tokens = torch.randn(2 * pcfg.num_frames, 16, pcfg.embed_dim)
    q = torch.as_tensor(batch["question"])
    run = lambda **kw: PA.heads(pp, f_a, tokens, None, q, pcfg, **kw)["out_qa"]
    assert torch.equal(run(train=True), run())
    assert not torch.equal(run(train=True, gen=torch.Generator().manual_seed(0)), run())


def test_eval_step_is_the_eval_forward_without_nega(model):
    _, pcfg, _, _, pp, ps, batch = model
    tr, fr = PT.partition_params(pp)
    out = PT.make_eval_step(pcfg, device="cpu")(tr, fr, ps, batch)
    with torch.inference_mode():
        ref = PA.forward(pp, ps, batch["wave"], batch["visual_posi"], batch["visual_nega"],
                         batch["question"], pcfg, device="cpu")
    assert out.shape == (2, 42) and torch.equal(out, ref["out_qa"])


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [1, 2])
def test_main_smoke(stage, capsys):
    m = avqa_main.main(["--mode", "smoke", "--stage", str(stage), "--device", "cpu",
                        "--batch-size", "2"], cfg=port_avqa_cfg(tiny_avqa4_cfg()))
    assert f"stage-{stage} smoke:" in capsys.readouterr().out
    assert np.isfinite(m["loss"]) and set(m) == ({"loss", "acc"} if stage == 1
                                                 else {"loss", "qa_acc"})


def test_main_two_stages_and_eval(tmp_path, capsys):
    """Stage 1 over an on-disk tree saves grounding_gen_best.npz; stage 2
    takes its heads over, saves avst_best.npz and reports the per-type
    accuracies in [0, 100] with the best weights; --mode eval from that
    checkpoint reports the same."""
    cfg = port_avqa_cfg(tiny_avqa4_cfg())
    root = str(tmp_path)
    t = media_tree.make_avqa_tree(root, ["qa0", "qa1", "qa2"], n_frames=3, img_size=64,
                                  wave_samples=2 * cfg.htsat.frontend.clip_samples, n_q=4)
    save = os.path.join(root, "ckpt")
    common = ["--meta", root, "--frames", t["frames"], "--audio", t["audio"], "--batch-size",
              "2", "--epochs", "1", "--save-dir", save, "--device", "cpu"]
    s1 = avqa_main.main(["--mode", "train", "--stage", "1"] + common, cfg=cfg)
    assert s1 == os.path.join(save, "grounding_gen_best.npz") and os.path.exists(s1)
    assert "val match acc" in capsys.readouterr().out
    s1_params, _ = PCK.load_params_and_state(s1)
    assert sorted(s1_params) == sorted(HEADS + ("htsat", "swin"))

    accs = avqa_main.main(["--mode", "train", "--stage", "2", "--stage1-ckpt", s1] + common,
                          cfg=cfg)
    text = capsys.readouterr().out
    assert "transferred stage-1 heads" in text and "saved best" in text
    assert "test Avg accuracy" in text
    assert all(0.0 <= v <= 100.0 for v in accs.values())
    assert {"Avg", "Audio", "Audio/Counting", "Audio-Visual/Existential"} <= set(accs)
    best = os.path.join(save, "avst_best.npz")
    with open(best + ".meta.json") as f:
        assert json.load(f)["epoch"] == 1
    with open(os.path.join(save, "avqa.metrics.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    assert any(e["event"] == "scalars" and "test/Avg" in e for e in events)
    again = avqa_main.main(["--mode", "eval", "--ckpt", best] + common, cfg=cfg)
    assert again == pytest.approx(accs)
    with pytest.raises(SystemExit, match="--meta"):
        avqa_main.main(["--mode", "train", "--device", "cpu"], cfg=cfg)
    with pytest.raises(SystemExit, match="stage 2"):
        avqa_main.main(["--mode", "eval", "--stage", "1"] + common, cfg=cfg)


def test_main_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        avqa_main.main(["--mode", "smoke"])
