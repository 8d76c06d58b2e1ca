"""The port's pretrain, few-shot and zero-shot entry points
(dg_sct_tpu_torch.train.pretrain_main, few_shot_main, zero_shot_main) on the
CPU with `--device cpu` at the tiny pretrain configuration of
tests/test_torch_pretrain.py: each smoke mode, then the real-data modes
over small on-disk trees (tests/media_tree.py): pretrain training for one
epoch over a VGGSound-AVEL tree (saves `pretrain_best.npz`) and its eval,
zero-shot eval from that checkpoint on AVE (events and --cls) and LLP trees
(the class lists differ, so restore_matching skips the class-sized
leaves), and few-shot training on AVE (cls, and events with the background
prompt) and LLP. Scores are percentages in [0, 100]; losses finite."""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import dg_sct_tpu_torch.configs as PC
from dg_sct_tpu_torch.train import few_shot_main, pretrain_main, zero_shot_main
from dg_sct_tpu_torch.utils import checkpoint as ckpt
from media_tree import make_ave_tree, make_llp_tree, make_vggsound_tree
from test_torch_pretrain import NAMES, port_pretrain_cfg, tiny_pretrain_cfg

VGG_CATS = ["dog barking", "playing violin", "people whistling"]
AVE_CATS = ["Church bell", "Bark", "Flute", "Banjo"]
LLP_IDS = ["vid00000001_0_10", "vid00000002_0_10", "vid00000003_0_10", "vid00000004_0_10"]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return port_pretrain_cfg(tiny_pretrain_cfg())


def with_classes(cfg, n, **kw):
    return dataclasses.replace(cfg, num_classes=n, **kw)


def test_smoke_modes(cfg, capsys):
    loss = pretrain_main.main(["--mode", "smoke", "--device", "cpu"], cfg=cfg, classnames=NAMES)
    assert math.isfinite(loss)
    loss = few_shot_main.main(["--mode", "smoke", "--device", "cpu", "--k-shot", "2"], cfg=cfg,
                              classnames=NAMES)
    assert math.isfinite(loss)
    acc = zero_shot_main.main(["--mode", "smoke", "--device", "cpu", "--dataset", "LLP"],
                              cfg=with_classes(cfg, 25))
    assert 0.0 <= acc <= 100.0
    out = capsys.readouterr().out
    for line in ("pretrain smoke: loss=", "few-shot smoke: loss=", "k-shot sampler: kept 6 of 60",
                 "zero-shot smoke: scores (2, 25)"):
        assert line in out, out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrain_trees")
    (root / "ave").mkdir()
    vgg = make_vggsound_tree(str(root / "vgg"), [f"{i:06d}" for i in range(6)], VGG_CATS,
                             n_frames=3, img_size=40, wave_samples=4000)
    ave = make_ave_tree(str(root / "ave"), [f"ave{i:03d}" for i in range(4)], AVE_CATS,
                        n_frames=3, img_size=40, wave_samples=4000)
    llp = make_llp_tree(str(root / "llp"), LLP_IDS, n_frames=3, img_size=40, wave_samples=4000)
    return {"vgg": vgg, "ave": ave, "llp": llp, "root": root}


@pytest.fixture(scope="module")
def pretrained(cfg, trees):
    save = trees["root"] / "ckpt"
    vgg = trees["vgg"]
    path = pretrain_main.main(["--mode", "train", "--device", "cpu", "--root", vgg["meta"],
                               "--frames", vgg["frames"], "--audio", vgg["audio"], "--epochs",
                               "1", "--batch-size", "2", "--save-dir", str(save)],
                              cfg=with_classes(cfg, len(VGG_CATS)), classnames=VGG_CATS)
    return path


def test_pretrain_train_and_eval_on_disk(cfg, trees, pretrained, capsys):
    assert pretrained and os.path.exists(pretrained)
    assert pretrained.endswith("pretrain_best.npz")
    params, state = ckpt.load_params_and_state(pretrained)
    assert params["clap_text_features"].shape == (len(VGG_CATS), cfg.clip.embed_dim)
    assert int(state["htsat"]["bn0"]["count"]) == 1   # 3 train clips at B=2: one step
    vgg = trees["vgg"]
    acc = pretrain_main.main(["--mode", "eval", "--device", "cpu", "--root", vgg["meta"],
                              "--frames", vgg["frames"], "--audio", vgg["audio"], "--ckpt",
                              pretrained, "--batch-size", "2"],
                             cfg=with_classes(cfg, len(VGG_CATS)), classnames=VGG_CATS)
    assert 0.0 <= acc <= 100.0
    assert "test weak accuracy" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["events", "cls", "llp"])
def test_zero_shot_eval_on_disk(cfg, trees, pretrained, mode, capsys):
    ave, llp = trees["ave"], trees["llp"]
    if mode == "llp":
        argv = ["--dataset", "LLP", "--label-test", os.path.join(llp["root"], "AVVP_test_pd.csv"),
                "--frames", llp["frames"], "--audio", llp["audio"]]
        run_cfg = with_classes(cfg, 25)
    else:
        argv = ["--dataset", "AVE", "--meta", ave["meta"], "--frames", ave["frames"],
                "--audio", ave["audio"]] + (["--cls"] if mode == "cls" else [])
        run_cfg = with_classes(cfg, len(AVE_CATS))
    acc = zero_shot_main.main(["--mode", "eval", "--device", "cpu", "--ckpt", pretrained,
                               "--batch-size", "3"] + argv, cfg=run_cfg)
    assert 0.0 <= acc <= 100.0
    out = capsys.readouterr().out
    assert "ckpt: skipped" in out   # the class-sized leaves of another class list
    assert ("events" if mode == "events" else "cls") + " accuracy" in out


@pytest.mark.parametrize("task", ["cls", "events", "llp"])
def test_few_shot_train_on_disk(cfg, trees, pretrained, task, tmp_path):
    ave, llp = trees["ave"], trees["llp"]
    if task == "llp":
        argv = ["--dataset", "LLP", "--label-train", os.path.join(llp["root"], "AVVP_train.csv"),
                "--label-test", os.path.join(llp["root"], "AVVP_test_pd.csv"), "--frames",
                llp["frames"], "--audio", llp["audio"]]
        run_cfg = with_classes(cfg, 25)
    else:
        argv = ["--dataset", "AVE", "--task", task, "--meta", ave["meta"], "--frames",
                ave["frames"], "--audio", ave["audio"]]
        run_cfg = with_classes(cfg, len(AVE_CATS), prompt=PC.PromptConfig(weak=task == "cls"))
    classes = list(range(run_cfg.num_classes))
    best = few_shot_main.main(["--mode", "train", "--device", "cpu", "--k-shot", "1",
                               "--epochs", "1", "--batch-size", "2", "--ckpt", pretrained,
                               "--save-dir", str(tmp_path)] + argv, cfg=run_cfg,
                              classnames=[f"c{i}" for i in classes])
    assert 0.0 <= best <= 100.0
    name = f"few_shot_{'LLP' if task == 'llp' else 'AVE'}_{'cls' if task == 'llp' else task}"
    assert (tmp_path / f"{name}_best.npz").exists()
    params, _ = ckpt.load_params_and_state(str(tmp_path / f"{name}_best.npz"))
    n_prompts = run_cfg.num_classes + (task == "events")
    assert np.shape(params["clap_text_features"]) == (n_prompts, cfg.clip.embed_dim)
