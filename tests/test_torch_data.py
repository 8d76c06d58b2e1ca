"""The port's host ingest (dg_sct_tpu_torch.data.ave, .native and the
wire-format ops) against the JAX package on the same on-disk AVE trees:
dataset items equal (uint8, int16 and mu-law exactly, float frames to 1e-6)
with the same decoder on both sides, labels and loading as JAX's, the
threaded loader's order and errors, and the wire-format ops at float32,
atol 1e-5."""
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import dg_sct_tpu.native as JN
import dg_sct_tpu_torch.native as PN
from dg_sct_tpu.data import ave as JD
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.ops import dsp as JDSP
from dg_sct_tpu_torch.data import ave as PD
from dg_sct_tpu_torch.ops import basic as PB
from dg_sct_tpu_torch.ops import dsp as PDSP
import media_tree

REPO = Path(__file__).resolve().parents[1]
CATS = ["dog", "cat", "bell"]
FORMATS = {
    "float": ("f32", {}),
    "u8": ("f32", {"raw_u8": True}),
    "yuv420": ("f32", {"yuv420": True}),
    "mulaw": ("f32", {"wave_mulaw": True, "raw_u8": True}),
    "i16": ("i16", {"raw_u8": True}),
    "i16_yuv420_mulaw": ("i16", {"yuv420": True, "wave_mulaw": True}),
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    out = {}
    for name, dtype in (("f32", np.float32), ("i16", np.int16)):
        root = str(tmp_path_factory.mktemp(f"ave_{name}"))
        out[name] = (root, media_tree.make_ave_tree(root, [f"{name}{i}" for i in range(4)], CATS,
                                                    n_frames=3, img_size=80,
                                                    wave_samples=3 * 1000, wave_dtype=dtype))
    return out


def _dataset(mod, tree, kw):
    root, t = tree
    return mod.AVEDataset(root, "test", img_size=64, frame_dir=t["frames"],
                          audio_dir=t["audio"], num_frames=4, segment_samples=1600, **kw)


@pytest.mark.parametrize("decoder", ["native", "pil"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_items_equal_jax(trees, fmt, decoder, monkeypatch):
    if decoder == "pil":
        monkeypatch.setattr(JN, "available", lambda: False)
        monkeypatch.setattr(PN, "available", lambda: False)
    else:
        assert JN.available() and PN.available(), (JN._build_failed, PN.build_error())
    tree, kw = FORMATS[fmt]
    jds, pds = _dataset(JD, trees[tree], kw), _dataset(PD, trees[tree], kw)
    assert pds.ids == jds.ids and len(pds) == 4
    for i in range(len(pds)):
        got, ref = pds[i], jds[i]
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            if ref[k].dtype == np.float32 and k.startswith("image"):
                np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(pds.label(i), ref["GT"])


def test_annotations_and_split_ids(tmp_path):
    ann = tmp_path / "Annotations.txt"
    ann.write_text("Category&VideoID&Quality&StartTime&EndTime\n"
                   "dog&v0&good&2&5\ncat&v1&good&0.0&10.0\nbell&v2&bad&-1&3\n"
                   "short&row\n\nbell&v3&good&8&12\n")
    got, ref = PD.parse_annotations(str(ann), CATS), JD.parse_annotations(str(ann), CATS)
    assert [v for v, _ in got] == [v for v, _ in ref] == ["v0", "v1", "v2", "v3"]
    for (_, g), (_, r) in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    v0 = dict(got)["v0"]
    assert v0.shape == (10, 4)
    assert (v0[2:5, 0] == 1).all() and (v0[[0, 1, 5, 9], 3] == 1).all()
    # a split row needs only two fields
    assert PD.load_split_ids(str(ann)) == JD.load_split_ids(str(ann)) == ["v0", "v1", "v2",
                                                                          "row", "v3"]


@pytest.mark.parametrize("n,dtype", [(700, np.float64), (1600 * 4 + 9, np.float32),
                                     (1000, np.int16)])
def test_load_wave_tiles_and_crops(tmp_path, n, dtype):
    wave = (np.arange(n) % 97 - 48).astype(dtype)
    np.save(tmp_path / "v.npy", wave)
    got = PD.load_wave(str(tmp_path), "v", 4, 1600)
    np.testing.assert_array_equal(got, JD.load_wave(str(tmp_path), "v", 4, 1600))
    assert got.shape == (4, 1600)
    assert got.dtype == (np.int16 if dtype == np.int16 else np.float32)
    np.testing.assert_array_equal(got.reshape(-1), np.resize(wave, 6400).astype(got.dtype))


class Items:
    """A map-style dataset of distinct numbered items; index `bad` raises."""

    def __init__(self, n, bad=None):
        self.n, self.bad = n, bad
        self.lock = threading.Lock()
        self.reads = 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        with self.lock:
            self.reads += 1
        if i == self.bad:
            raise OSError(f"cannot decode item {i}")
        return {"wave": np.full((2, 8), i, np.int16), "image": np.full((2, 4, 4, 3), i, np.uint8),
                "GT": np.zeros((2, 29), np.float32), "name": f"clip{i}"}


@pytest.mark.parametrize("drop_last", [False, True])
def test_batched_iterator_order_and_tail(drop_last):
    batches = list(PD.batched_iterator(Items(7), 3, shuffle=False, drop_last=drop_last,
                                       num_workers=3, prefetch=1))
    assert [b["wave"][:, 0, 0].tolist() for b in batches] == \
        [[0, 1, 2], [3, 4, 5]] + ([] if drop_last else [[6]])
    assert batches[0]["image"].shape == (3, 2, 4, 4, 3) and batches[0]["gt"].shape == (3, 2, 29)
    assert batches[1]["name"] == ["clip3", "clip4", "clip5"]


def test_batched_iterator_shuffles_as_jax():
    got = [b["wave"][:, 0, 0].tolist() for b in PD.batched_iterator(Items(9), 2, seed=3)]
    ref = [b["wave"][:, 0, 0].tolist() for b in JD.batched_iterator(Items(9), 2, seed=3)]
    assert got == ref and sorted(sum(got, [])) == sorted(sum(ref, []))


def test_batched_iterator_raises_worker_errors_and_stops():
    it = PD.batched_iterator(Items(9, bad=4), 2, shuffle=False, num_workers=2)
    assert next(it)["wave"][:, 0, 0].tolist() == [0, 1]
    assert next(it)["wave"][:, 0, 0].tolist() == [2, 3]
    with pytest.raises(OSError, match="item 4"):
        next(it)
    items = Items(1000)
    it = PD.batched_iterator(items, 2, shuffle=False, num_workers=2, prefetch=1)
    next(it)
    it.close()  # the producer stops instead of decoding the rest
    assert items.reads < 20


def test_synthetic_batch_and_collate_equal_jax():
    got = PD.synthetic_batch(3, img_size=16, num_segments=4, sr=100, seed=5)
    ref = JD.synthetic_batch(3, img_size=16, num_segments=4, sr=100, seed=5)
    assert sorted(got) == sorted(ref) == ["gt", "image", "wave"]
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    items = [Items(3)[i] for i in range(3)]
    got, ref = PD.default_collate(items), JD.default_collate(items)
    assert sorted(got) == sorted(ref) and got["name"] == ref["name"] == ["clip0", "clip1", "clip2"]
    for k in ("wave", "image", "gt"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_device_prefetch_passes_through_on_cpu():
    src = [{"wave": np.full((2, 8), i, np.int16), "ids": [i]} for i in range(4)]
    out = list(PD.device_prefetch(iter(src), device="cpu", size=2))
    assert [b["ids"] for b in out] == [[0], [1], [2], [3]]
    assert all(o is s for o, s in zip(out, src))

    def bad():
        yield src[0]
        raise RuntimeError("decode failed")

    it = PD.device_prefetch(bad(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


@pytest.mark.parametrize("lead", [(3,), (2, 2)])
def test_normalize_frames_yuv420(lead):
    rs = np.random.RandomState(0)
    y = rs.randint(0, 256, lead + (16, 16), dtype=np.uint8)
    uv = rs.randint(0, 256, lead + (8, 8, 2), dtype=np.uint8)
    got = PB.normalize_frames_yuv420(torch.from_numpy(y), torch.from_numpy(uv), torch.float32)
    ref = np.asarray(JB.normalize_frames_yuv420(y, uv, dtype=np.float32))
    assert got.shape == lead + (16, 16, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel,align", [("cubic", False), ("cubic", True), ("linear", False)])
def test_resize_2d(kernel, align):
    x = np.random.RandomState(1).randn(2, 6, 10, 3).astype(np.float32)
    got = PDSP.resize_2d(torch.from_numpy(x), 12, 7, kernel=kernel, align_corners=align)
    ref = np.asarray(JDSP.resize_2d(x, 12, 7, kernel=kernel, align_corners=align))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_encode_mulaw_u8():
    rs = np.random.RandomState(2)
    wave = np.concatenate([rs.randn(1000) * 0.3, [-2.0, -1.0, 0.0, 1.0, 2.0]]).astype(np.float32)
    pcm = (np.clip(wave, -1, 1) * 32767).astype(np.int16)
    for w in (wave, pcm):
        got = PB.encode_mulaw_u8(w)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(JB.encode_mulaw_u8(w)))
        back = PB.dequantize_mulaw_u8(torch.from_numpy(got)).numpy()
        np.testing.assert_allclose(back, np.asarray(JB.dequantize_mulaw_u8(got)), atol=1e-5)


def test_native_build_writes_only_its_build_dir(tmp_path, monkeypatch):
    """The port's core builds with the JAX flags into its own build
    directory: nothing beside the source and nothing under dg_sct_tpu/."""
    cmds = []
    real_run = PN.subprocess.run

    def run(cmd, **kw):
        cmds.append(list(cmd))
        return real_run(cmd, **kw)

    monkeypatch.setattr(PN, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(PN.subprocess, "run", run)
    assert PN.available(), PN.build_error()
    lib = PN.build_dir() / "libdgsct_io.so"
    assert lib.is_file() and lib.parent.parent == tmp_path / "_build"
    assert cmds and all(c[0] == "g++" for c in cmds)
    assert {"-O3", "-fno-math-errno", "-fopenmp", "-march=x86-64-v3"} <= set(cmds[0])
    for c in cmds:
        out = Path(c[c.index("-o") + 1]).resolve()
        assert tmp_path in out.parents
        assert REPO / "dg_sct_tpu" not in out.parents
    assert not list(PN.SRC.parent.glob("*.so"))


def test_native_batch_status_is_atomic(tmp_path):
    """A file that cannot be read fails the whole batch; every write of the
    shared status in the batched loaders is an `omp atomic write`."""
    lines = PN.SRC.read_text().splitlines()
    writes = [i for i, ln in enumerate(lines) if ln.strip() == "status = -1;"]
    assert len(writes) == 6
    assert all(lines[i - 1].strip() == "#pragma omp atomic write" for i in writes)
    assert PN.available(), PN.build_error()
    media_tree.save_jpegs(str(tmp_path), 2, 40)
    good = sorted(str(p) for p in tmp_path.glob("*.jpg"))
    y, uv = PN.load_jpeg_batch_yuv420(good, 32)
    assert y.shape == (2, 32, 32) and uv.shape == (2, 16, 16, 2)
    with pytest.raises(RuntimeError, match="yuv420"):
        PN.load_jpeg_batch_yuv420(good + [str(tmp_path / "missing.jpg")] + good, 32)


def test_native_rebuilds_a_library_that_does_not_load(tmp_path, monkeypatch):
    """A library left by another machine that does not load here is built
    again rather than reported missing."""
    monkeypatch.setattr(PN, "BUILD_ROOT", tmp_path / "_build")
    lib = PN.build_dir() / "libdgsct_io.so"
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"not a shared object")
    assert PN.available(), PN.build_error()
    assert PN.build_error() is None and lib.stat().st_size > 1000
