"""Checkpoint import in the port (dg_sct_tpu_torch.utils.torch_convert,
.utils.checkpoint, .tools.import_eval) against the JAX package: the
converter's tree equal leaf for leaf and its census report equal on a tiny
DG-SCT state dict and on the full-width key censuses of best_82.18.pt and
HTSAT_AudioSet_Saved_1.ckpt; the converted tiny model's forward against
JAX's (atol 2e-4, rtol 2e-3); npz bundles read across both packages; the
one-command tool's gates, exit codes and accuracy."""
import json
import zlib
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from dg_sct_tpu.configs import ave_adapter_dims
from dg_sct_tpu.data import ave as JD
from dg_sct_tpu.models import ave as JA
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.tools import import_eval as JIE
from dg_sct_tpu.train.metrics import ave_accuracy as jax_ave_accuracy
from dg_sct_tpu.utils import checkpoint as JCK
from dg_sct_tpu.utils import torch_convert as JTC
from dg_sct_tpu_torch.configs import AVEModelConfig
from dg_sct_tpu_torch.models import ave as PA
from dg_sct_tpu_torch.tools import import_eval
from dg_sct_tpu_torch.train.metrics import ave_accuracy
from dg_sct_tpu_torch.utils import checkpoint as PCK
from dg_sct_tpu_torch.utils import torch_convert as PTC
from dg_sct_tpu_torch.weights import from_jax
import media_tree
from test_ave_model import tiny_cfg
from test_torch_convert import fake_torch_sd
from torch_port_helpers import port_cfg

ATOL, RTOL = 2e-4, 2e-3
GOLD = Path(__file__).resolve().parent / "golden"
CATS = [f"c{i}" for i in range(28)]


@pytest.fixture(scope="module", autouse=True)
def flush_denormals():
    """Random test weights drive activations into float32 denormals, which
    the CPU computes ~50x slower; flushing them moves no output beyond 1e-30."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores; a full set of intra-op threads
    in each of them oversubscribes the machine and slows these tiny
    forwards by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def assert_trees_equal(got, ref, path="tree"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), path
        for k in ref:
            assert_trees_equal(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_trees_equal(g, r, f"{path}[{i}]")
    else:
        g, r = np.asarray(got), np.asarray(ref)
        assert g.dtype == r.dtype and g.shape == r.shape, (path, g.dtype, r.dtype, g.shape)
        assert np.array_equal(g, r), path


def convert_both(sd, convert):
    """The same state dict through both packages' converters -> (port tree,
    JAX tree, port census, JAX census)."""
    psd, jsd = PTC.track(dict(sd)), JTC.track(dict(sd))
    return convert(PTC, psd), convert(JTC, jsd), PTC.census_report(psd), JTC.census_report(jsd)


def digest(tree):
    """The tree with each leaf as (dtype, shape, crc32 of its bytes)."""
    if isinstance(tree, dict):
        return {k: digest(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [digest(v) for v in tree]
    a = np.ascontiguousarray(tree)
    return str(a.dtype), a.shape, zlib.crc32(a.data)


def convert_in_turn(sd, convert):
    """As `convert_both`, with JAX's tree kept only as a digest, so that one
    full-width tree is in memory at a time -> (port tree, JAX digest, port
    census, JAX census)."""
    jsd = JTC.track(dict(sd))
    jax_digest = digest(convert(JTC, jsd))
    psd = PTC.track(dict(sd))
    return convert(PTC, psd), jax_digest, PTC.census_report(psd), JTC.census_report(jsd)


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_cfg()
    n = len(ave_adapter_dims(jcfg.swin, jcfg.htsat))
    sd = fake_torch_sd(jcfg)
    (pp, ps), (jp, js), prep, jrep = convert_both(sd, lambda m, d: m.convert_ave_model(d, n))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")  # the parity form, whatever ran before
        fwd = jax.jit(lambda p, s, w, i: JA.forward(p, s, w, i, jcfg, train=False)[0])
        yield jcfg, port_cfg(jcfg), sd, (pp, ps), (jp, js), prep, jrep, fwd


def test_tiny_converter_equals_jax(tiny):
    _, _, sd, (pp, ps), (jp, js), prep, jrep, _ = tiny
    assert_trees_equal(pp, jp, "params")
    assert_trees_equal(ps, js, "state")
    assert prep == jrep
    assert not prep["unexplained"] and prep["ignored"]
    assert sorted(prep["consumed"] + prep["ignored"]) == sorted(sd)


def test_tiny_converted_forward_matches_jax(tiny):
    jcfg, pcfg, _, (pp, ps), (jp, js), _, _, fwd = tiny
    rs = np.random.RandomState(3)
    wave = (rs.randn(2, jcfg.num_frames, jcfg.htsat.frontend.clip_samples) * 0.3).astype(np.float32)
    imgs = rs.randn(2, jcfg.num_frames, 64, 64, 3).astype(np.float32)
    tp, ts = from_jax(pp, ps, pcfg, device="cpu")
    got = PA.forward(tp, ts, wave, imgs, pcfg, device="cpu")
    ref = fwd(jp, js, wave, imgs)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def census_sd(name, prefix=""):
    """A state dict with exactly the census's keys, shapes and integer
    dtypes; floats hold a cheap int8 pattern that differs per key, so a
    full-width dict costs 0.46 GB and not 1.85."""
    with open(GOLD / name) as f:
        census = json.load(f)
    ramp = np.arange(-63, 64, dtype=np.int8)
    sd = {}
    for k, spec in census.items():
        dtype = np.dtype(spec["dtype"])
        if dtype.kind in "iu":
            sd[k[len(prefix):] if k.startswith(prefix) else k] = np.zeros(spec["shape"], dtype)
        else:
            sd[k[len(prefix):] if k.startswith(prefix) else k] = np.resize(
                np.roll(ramp, zlib.crc32(k.encode()) % 127), spec["shape"])
    return sd


def assert_shapes(tree, ref, path):
    if isinstance(ref, dict):
        assert sorted(tree) == sorted(ref), path
        for k in ref:
            assert_shapes(tree[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(tree) == len(ref), path
        for i, (t, r) in enumerate(zip(tree, ref)):
            assert_shapes(t, r, f"{path}[{i}]")
    else:
        assert tuple(np.shape(tree)) == tuple(ref.shape), path


def test_full_width_ave_census():
    """best_82.18.pt's census: both converters give the same tree and the
    same report, no key is unexplained, and `from_jax` takes the tree on the
    meta device at the shipping AVEModelConfig()."""
    port, jax_digest, prep, jrep = convert_in_turn(census_sd("census_best_82_18.json"),
                                                   lambda m, d: m.convert_ave_model(d))
    assert prep == jrep and not prep["unexplained"]
    assert len(prep["ignored"]) > 100 and len(prep["consumed"]) > 1500
    assert digest(port) == jax_digest
    pp, ps = port
    tp, ts = from_jax(pp, ps, AVEModelConfig(), device="meta")
    assert tp["swin"]["layers"][2]["blocks"][17]["mlp"]["fc1"]["kernel"].shape == (768, 3072)


def test_full_width_htsat_census():
    sd = census_sd("census_htsat_audioset.json", prefix="sed_model.")
    port, jax_digest, prep, jrep = convert_in_turn(sd, lambda m, d: m.convert_htsat(d))
    assert prep == jrep and not prep["unexplained"]
    assert digest(port) == jax_digest
    pp, ps = port
    ref_p, ref_s = PA.init_ave_model(AVEModelConfig(), device="meta")
    assert_shapes(pp, ref_p["htsat"], "htsat params")
    assert_shapes(ps, ref_s["htsat"], "htsat state")


def test_npz_bundles_read_across_packages(tmp_path):
    tree = {"params": {"a": [np.arange(6, dtype=np.float32).reshape(2, 3),
                             {"k": np.ones((4,), np.float32)}],
                       "b": {"kernel": np.full((2, 2), 3.0, np.float32)}},
            "state": {"bn": {"count": np.asarray(5, np.int32), "var": np.ones(3, np.float32)}}}
    JCK.save_params(str(tmp_path / "jax.npz"), tree)
    p, s = PCK.load_params_and_state(str(tmp_path / "jax.npz"))
    assert_trees_equal({"params": p, "state": s}, tree)
    torch_tree = {"params": {"a": [torch.arange(6.0).reshape(2, 3), {"k": torch.ones(4)}],
                             "b": {"kernel": np.full((2, 2), 3.0, np.float32)}},
                  "state": {"bn": {"count": torch.tensor(5, dtype=torch.int32),
                                   "var": torch.ones(3)}}}
    PCK.save_params(str(tmp_path / "port.npz"), torch_tree)
    p, s = JCK.load_params_and_state(str(tmp_path / "port.npz"))
    assert_trees_equal({"params": p, "state": s}, tree)
    assert_trees_equal(PCK.load_params(str(tmp_path / "port.npz")), tree)


def _save_sd(sd, path):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, str(path))
    return str(path)


def test_import_eval_gates_and_exit_codes(tiny, tmp_path, capsys):
    _, pcfg, sd, (pp, ps), _, _, _, _ = tiny
    pt = _save_sd(sd, tmp_path / "best.pt")
    out = tmp_path / "converted.npz"
    assert import_eval.main(["--ave-ckpt", pt, "--census-only", "--save", str(out)],
                            cfg=pcfg) is None
    assert "0 UNEXPLAINED" in capsys.readouterr().out
    p, s = JCK.load_params_and_state(str(out))  # the JAX package reads the bundle
    assert_trees_equal(p, pp)
    assert_trees_equal(s, ps)

    extra = _save_sd({**sd, "mystery.weight": np.zeros(3, np.float32)}, tmp_path / "extra.pt")
    with pytest.raises(SystemExit) as e:
        import_eval.main(["--ckpt", extra, "--census-only"], cfg=pcfg)
    assert e.value.code == 2
    assert import_eval.main(["--ckpt", extra, "--census-only", "--lax"], cfg=pcfg) is None
    key = "CMBS.video_cas.weight"
    bad = _save_sd({**sd, key: np.zeros((28, 7), np.float32)}, tmp_path / "bad.pt")
    with pytest.raises(SystemExit) as e:
        import_eval.main(["--ckpt", bad, "--census-only"], cfg=pcfg)
    assert e.value.code == 3
    # an AVE checkpoint under --task avqa: the AVQA converter stops at its
    # first missing key, before the census, as the JAX tool does on the file
    with pytest.raises(KeyError) as e:
        import_eval.main(["--task", "avqa", "--ckpt", pt, "--census-only"])
    with pytest.raises(KeyError) as j:
        JIE.import_task_checkpoint("avqa", pt)
    assert e.value.args == j.value.args


def test_import_eval_accuracy_matches_jax(tiny, tmp_path):
    """The tool scores an on-disk split through predict_clips; its accuracy
    equals `ave_accuracy` over JAX's forward of the JAX-converted tree on the
    JAX dataset's items."""
    jcfg, pcfg, sd, _, (jp, js), _, _, fwd = tiny
    root = str(tmp_path)
    t = media_tree.make_ave_tree(root, [f"e{i}" for i in range(5)], CATS, n_frames=3,
                                 img_size=72, wave_samples=2000)
    pt = _save_sd(sd, tmp_path / "best.pt")  # the tree's files sit beside it
    acc = import_eval.main(["--ckpt", pt, "--meta", root, "--frames", t["frames"],
                            "--audio", t["audio"], "--batch-size", "2", "--device", "cpu"],
                           cfg=pcfg)
    jds = JD.AVEDataset(root, "test", img_size=jcfg.swin.img_size, frame_dir=t["frames"],
                        audio_dir=t["audio"], num_frames=jcfg.num_frames,
                        segment_samples=jcfg.htsat.frontend.clip_samples)
    items = [jds[i] for i in range(len(jds))]
    ie, ev = [], []
    for s in range(0, 5, 2):
        part = items[s:s + 2]
        k = len(part)
        part = part + [part[-1]] * (2 - k)
        out = fwd(jp, js, np.stack([x["wave"] for x in part]), np.stack([x["image"] for x in part]))
        ev.append(np.asarray(out["event_scores"])[:k])
        ie.append(np.asarray(out["is_event_scores"])[:k])
    gt = np.stack([x["GT"] for x in items])
    ref = float(jax_ave_accuracy(np.concatenate(ie), np.concatenate(ev), gt))
    assert acc == pytest.approx(ref, abs=1e-4)
    assert ave_accuracy(np.concatenate(ie), np.concatenate(ev), gt) == pytest.approx(ref,
                                                                                     abs=1e-4)
