"""The pieces of the port's training (dg_sct_tpu_torch: train-mode BN, the
stochastic ops, SpecAugment, mixup, losses, StepLR, the accumulated Adam,
the parameter partition and counts, the metrics log, the tree helpers)
against the JAX package's, on the same numpy inputs, float32, JAX at
matmul precision "highest". Tolerance: atol 1e-5, rtol 1e-5 for
elementwise ops and losses; the optimizer against optax: atol 1e-7, rtol
1e-5 (same gradients in, the same arithmetic)."""
import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dg_sct_tpu.configs import AudioFrontendConfig as JFrontend
from dg_sct_tpu.configs import TrainConfig as JTrainConfig
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.ops import dsp as JD
from dg_sct_tpu.train import ave_train as JT
from dg_sct_tpu.train import losses as JL
from dg_sct_tpu.train import optim as JO
from dg_sct_tpu.utils import metrics_log as JML
from dg_sct_tpu_torch import configs as PC
from dg_sct_tpu_torch.models import ave as PA
from dg_sct_tpu_torch.ops import basic as PB
from dg_sct_tpu_torch.ops import dsp as PD
from dg_sct_tpu_torch.train import ave_train as PT
from dg_sct_tpu_torch.train import losses as PL
from dg_sct_tpu_torch.train import optim as PO
from dg_sct_tpu_torch.utils import checkpoint as PCk
from dg_sct_tpu_torch.utils import metrics_log as PML
from dg_sct_tpu_torch.utils.tree import tree_leaves, tree_paths, tree_unflatten
from test_ave_model import tiny_cfg
from torch_port_helpers import port_cfg, to_numpy, to_torch

ATOL, RTOL = 1e-5, 1e-5
FE = dict(sample_rate=3200, clip_seconds=1, n_fft=256, hop_size=320, mel_bins=16,
          fmax=1500.0, spec_size=32, time_drop_width=8)


def close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(port).detach()), np.asarray(ref),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# train-mode BN and the stochastic ops
# ---------------------------------------------------------------------------

def test_batch_norm_train():
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 7, 5) * 2 + 1).astype(np.float32)
    p = {"scale": rs.rand(5).astype(np.float32) + 0.5, "bias": rs.randn(5).astype(np.float32)}
    s = {"mean": rs.randn(5).astype(np.float32), "var": rs.rand(5).astype(np.float32) + 0.5,
         "count": np.asarray(3, np.int32)}
    ref, ref_s = JB.batch_norm(p, s, jnp.asarray(x), train=True, axis=-1)
    got, got_s = PB.batch_norm(to_torch(p), to_torch(s), torch.from_numpy(x), train=True,
                               axis=-1)
    close(got, ref)
    for k in ("mean", "var"):
        close(got_s[k], ref_s[k])
    assert got_s["count"].dtype == torch.int32 and int(got_s["count"]) == int(ref_s["count"]) == 4
    assert not got_s["mean"].requires_grad


@pytest.mark.parametrize("op", ["dropout", "drop_path"])
def test_stochastic_apply_with_jax_mask(op):
    """The port's apply step fed the mask JAX drew gives JAX's output."""
    x = np.random.RandomState(1).randn(6, 4, 5).astype(np.float32) + 3.0  # no zeros
    rate = 0.3
    ref = np.asarray(getattr(JB, op)(jax.random.PRNGKey(3), jnp.asarray(x), rate, True))
    mask = torch.from_numpy(ref != 0)
    if op == "drop_path":
        mask = mask.reshape(6, -1)[:, 0]
        got = PB.apply_drop_path(torch.from_numpy(x), mask, rate)
    else:
        got = PB.apply_keep_mask(torch.from_numpy(x), mask, rate)
    close(got, ref)


def test_spec_augment_apply_with_jax_mask():
    cfg_j = JFrontend(**FE)
    x = np.random.RandomState(2).randn(4, 11, 16).astype(np.float32)
    key = jax.random.PRNGKey(5)
    m = np.asarray(JD.spec_augment(key, jnp.ones_like(jnp.asarray(x)), cfg_j))
    tmask, fmask = torch.from_numpy(m.max(2) > 0), torch.from_numpy(m.max(1) > 0)
    close(PD.apply_spec_masks(torch.from_numpy(x), tmask, fmask),
          JD.spec_augment(key, jnp.asarray(x), cfg_j))


def test_do_mixup():
    rs = np.random.RandomState(3)
    x, lam = rs.randn(6, 5, 4).astype(np.float32), rs.rand(6).astype(np.float32)
    close(PD.do_mixup(torch.from_numpy(x), torch.from_numpy(lam)),
          JD.do_mixup(jnp.asarray(x), jnp.asarray(lam)))


def test_port_draws_structure():
    """The port's own draws: drop_path keeps or zeroes whole rows, kept
    values scale by 1/keep, dropout acts per element; SpecAugment zeroes at
    most stripes_num stripes a row, each narrower than drop_width; rate 0
    or eval is the identity."""
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(64, 3, 5) + 1.0
    y = PB.drop_path(gen, x, 0.5, True)
    kept = (y != 0).reshape(64, -1)
    assert (kept.all(1) | ~kept.any(1)).all() and 0 < kept.all(1).sum() < 64
    torch.testing.assert_close(y[kept.all(1)], x[kept.all(1)] / 0.5)
    d = PB.dropout(gen, x, 0.25, True)
    assert 0 < (d == 0).sum() < d.numel() and not ((d == 0).reshape(64, -1).all(1)).all()
    torch.testing.assert_close(d[d != 0], x[d != 0] / 0.75)
    for fn in (PB.dropout, PB.drop_path):
        assert fn(gen, x, 0.0, True) is x and fn(gen, x, 0.5, False) is x

    cfg = PC.AudioFrontendConfig(**FE)
    T, Fm = 40, 16
    tmask, fmask = PD.spec_augment_masks(gen, 200, T, Fm, cfg, "cpu")
    for mask, width, num in ((tmask, cfg.time_drop_width, cfg.time_stripes_num),
                             (fmask, cfg.freq_drop_width, cfg.freq_stripes_num)):
        dropped = (~mask).int()
        # a run of zeros starts where a kept entry (or the row's start) is followed by a drop
        starts = dropped[:, :1] + (dropped[:, 1:] - dropped[:, :-1]).clamp(min=0).sum(1,
                                                                                     keepdim=True)
        assert int(starts.max()) <= num and dropped.sum(1).max() <= num * (width - 1)
        assert dropped.any()
    x = torch.rand(200, T, Fm) + 1.0
    y = PD.apply_spec_masks(x, tmask, fmask)
    torch.testing.assert_close(y != 0, tmask[:, :, None] & fmask[:, None, :])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_cases():
    rs = np.random.RandomState(4)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    gt = np.zeros((3, 5, 29), np.float32)
    gt[:, :, 28] = 1.0
    gt[0, 1:4, 28], gt[0, 1:4, 7] = 0.0, 1.0
    gt[2, :, 28], gt[2, :, 20] = 0.0, 1.0
    outs = {"is_event_scores": f(3, 5), "av_gate": f(3, 5), "event_scores": f(3, 28),
            "av_score": f(3, 28)}
    return {
        "bce_with_logits": ((f(4, 10), (rs.rand(4, 10) > 0.5).astype(np.float32)), {}),
        "bce_weighted": ((f(4, 10), rs.rand(4, 10).astype(np.float32),
                          rs.rand(4, 10).astype(np.float32)), {}),
        "cross_entropy": ((f(4, 28), rs.randint(0, 28, size=(4,))), {}),
        "info_nce": ((f(6, 8), f(6, 8)), {"temperature": 0.1}),
        "contrastive_loss": ((f(5, 8), f(5, 8), (rs.rand(5) > 0.5).astype(np.float32)), {}),
        "mask_info_nce": ((f(6, 8), f(7, 8), (rs.rand(6, 7) > 0.6).astype(np.float32)), {}),
        "ave_labels": ((gt,), {}),
        "ave_loss": ((outs, gt), {}),
    }


@pytest.mark.parametrize("name", list(_loss_cases()))
def test_losses_match_jax(name):
    args, kw = _loss_cases()[name]
    fn = name if name != "bce_weighted" else "bce_with_logits"
    ref = getattr(JL, fn)(*jax.tree_util.tree_map(jnp.asarray, args), **kw)
    got = getattr(PL, fn)(*to_torch(list(args)), **kw)
    for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        close(g, r)


# ---------------------------------------------------------------------------
# StepLR and the accumulated Adam against optax
# ---------------------------------------------------------------------------

def test_step_lr_matches_jax():
    args = (5e-4, 2, 0.1, 3)
    ours, ref = PO.step_lr(*args), JO.step_lr(*args)
    for count in range(14):
        np.testing.assert_allclose(ours(count), float(ref(jnp.asarray(count))), rtol=1e-6)


def test_accumulated_adam_matches_optax():
    """The same gradients through 6 mini-steps, accum 2: optax.MultiSteps
    over the JAX package's per-group Adam (lr 5e-4, `mlp_class` at 1e-3,
    StepLR decaying every applied update) against AccumulatedAdam. The
    parameters move only on every 2nd mini-step, and the schedule counts
    applied updates."""
    rs = np.random.RandomState(6)
    params = {"adapters": [{"w": rs.randn(4, 3).astype(np.float32)}],
              "mlp_class": {"b": rs.randn(5).astype(np.float32)},
              "CMBS": {"k": rs.randn(2, 2).astype(np.float32)}}
    jcfg = JTrainConfig(accum_steps=2, lr=5e-4, lr_mlp=1e-3, decay_epoch=1, decay=0.5)
    pcfg = PC.TrainConfig(accum_steps=2, lr=5e-4, lr_mlp=1e-3, decay_epoch=1, decay=0.5)
    tx = JT.make_optimizer(params, jcfg, steps_per_epoch=1)
    jp, jst = jax.tree_util.tree_map(jnp.asarray, params), None
    jst = tx.init(jp)
    opt = PT.make_optimizer(None, pcfg, steps_per_epoch=1)
    pp = to_torch(params)
    pst = opt.init(pp)
    for i in range(6):
        grads = jax.tree_util.tree_map(lambda a: rs.randn(*a.shape).astype(np.float32), params)
        upd, jst = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), jst, jp)
        jp = optax.apply_updates(jp, upd)
        before = pp
        pp, pst = opt.update([torch.from_numpy(g) for g in jax.tree_util.tree_leaves(grads)],
                             pst, pp)
        for (path, got), ref in zip(tree_paths(pp), jax.tree_util.tree_leaves(jp)):
            close(got, ref, atol=1e-7)
        if i % 2 == 0:
            assert all(a is b for a, b in zip(tree_leaves(pp), tree_leaves(before)))
        assert pst["gradient_step"] == int(jst.gradient_step)
        assert pst["mini_step"] == int(jst.mini_step)
        inner = jst.inner_opt_state
        for group in ("train", "mlp"):
            adam = inner.inner_states[group].inner_state[0]
            mus = [t for p, t in tree_paths(pst["mu"]) if PO.param_group(p) == group]
            ref_mus = [m for m in jax.tree_util.tree_leaves(adam.mu) if m.size]
            assert len(mus) == len(ref_mus) > 0
            for got, ref in zip(mus, ref_mus):
                close(got, ref, atol=1e-7)


# ---------------------------------------------------------------------------
# partition, counts, trees, metrics log
# ---------------------------------------------------------------------------

def test_partition_and_count_params():
    cfg = port_cfg(tiny_cfg())
    pp, _ = PA.init_ave_model(cfg, device="cpu")
    jp = to_numpy(pp)
    tr, fr = PT.partition_params(pp)
    jtr, jfr = JT.partition_params(jp)
    assert sorted(tr) == sorted(jtr) and sorted(fr) == sorted(jfr)
    assert PO.count_params(pp) == JO.count_params(jp)
    assert PO.group_labels({"mlp_class": {"a": 1}, "swin": [2], "CMBS": {"b": 3}}) == \
        JO.group_labels({"mlp_class": {"a": 1}, "swin": [2], "CMBS": {"b": 3}})


def test_tree_order_and_restore_structure():
    """Leaves in the JAX order (dict keys sorted), and restore_structure
    puts numpy leaves back as the template's tensors and numbers."""
    tree = {"b": [torch.ones(2), {"z": torch.zeros(1), "a": torch.full((3,), 2.0)}],
            "a": torch.arange(2, dtype=torch.int32), "n": 3}
    jtree = jax.tree_util.tree_map(lambda t: np.asarray(t), tree)
    assert [p for p, _ in tree_paths(tree)] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    loaded = PCk.restore_structure(tree, to_numpy(jtree))
    for a, b in zip(tree_leaves(loaded), tree_leaves(tree)):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError):
        tree_unflatten(tree, [1, 2])


def test_metrics_logger_matches_jax(tmp_path):
    config = {"lr": 5e-4, "mode": "train", "batch_size": 8}
    records = {}
    for name, mod in (("jax", JML), ("port", PML)):
        d = tmp_path / name
        with mod.MetricsLogger(str(d), run_name="ave", config=config) as log:
            log.log({"loss": np.float32(0.25), "acc": 71.5}, step=3, prefix="train/")
            log.log({"acc": 80.0, "note": "x"}, step=10, prefix="val/")
        lines = (d / "ave.metrics.jsonl").read_text().splitlines()
        records[name] = [{k: v for k, v in json.loads(ln).items() if k != "time"}
                         for ln in lines]
    assert records["port"] == records["jax"] and len(records["port"]) == 3
    code = PML.snapshot_run(str(tmp_path / "snap"), config=config)
    meta = json.loads((tmp_path / "snap" / "run_meta.json").read_text())
    assert meta["config"] == {k: PML._to_scalar(v) for k, v in config.items()}
    assert (tmp_path / "snap" / "code" / "train" / "ave_main.py").exists() and code
