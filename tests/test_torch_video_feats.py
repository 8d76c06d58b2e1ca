"""The port's widened convolutions, the video feature backbones, feature
extraction and wav preprocessing (dg_sct_tpu_torch) against the JAX
package on the same seeded numpy inputs and weights, float32. Tolerances:
convolutions and pools atol 1e-5 (exact for the pools); whole backbones
within 1e-5 of their largest output; the stride-1 "SAME" callers and
`wav_to_wave_npy` bit for bit."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from dg_sct_tpu.data import feature_extract as JFE
from dg_sct_tpu.data import preprocess as JPP
from dg_sct_tpu.models import video_feats as JV
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu_torch.data import feature_extract as PFE
from dg_sct_tpu_torch.data import preprocess as PPP
from dg_sct_tpu_torch.models import video_feats as PV
from dg_sct_tpu_torch.ops import basic as PB
from dg_sct_tpu_torch.utils.tree import tree_map, tree_paths
from dg_sct_tpu_torch.weights import from_jax_tree

ATOL = 1e-5
MODEL_RTOL = 1e-5  # of the largest |output|


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def numpy_tree(tree):
    return tree_map(lambda a: a.numpy(), tree)


def jax_conv(x, k, stride, padding, dilation, groups, nd):
    spec = {2: ("NHWC", "HWIO", "NHWC"), 3: ("NTHWC", "THWIO", "NTHWC")}[nd]
    return np.asarray(jax.lax.conv_general_dilated(
        x, k, (stride,) * nd if isinstance(stride, int) else stride, padding,
        rhs_dilation=(dilation,) * nd, feature_group_count=groups, dimension_numbers=spec))


# (H, W, kernel, stride, padding, dilation, groups)
CONV2D_CASES = [
    (9, 9, 3, 2, "SAME", 1, 1), (10, 10, 3, 2, "SAME", 1, 1), (9, 10, 2, 2, "SAME", 1, 1),
    (10, 9, 7, 4, "SAME", 1, 1), (11, 8, 3, 3, "SAME", 1, 1), (9, 9, 3, 1, "SAME", 2, 1),
    (10, 10, 3, 2, "VALID", 1, 1), (9, 9, 4, 4, "VALID", 1, 1), (12, 11, 3, 1, "VALID", 2, 1),
    (9, 9, 3, 2, ((1, 2), (0, 1)), 1, 1), (10, 10, 7, 2, ((3, 3), (3, 3)), 1, 1),
    (10, 10, 3, 1, "SAME", 1, 4), (9, 9, 3, 2, ((1, 1), (1, 1)), 1, 4),
    (10, 10, 3, 1, "SAME", 1, 2), (9, 10, 3, 2, "SAME", 2, 2),
]


@pytest.mark.parametrize("case", CONV2D_CASES, ids=lambda c: "-".join(map(str, c[:4])) +
                         f"-{c[4] if isinstance(c[4], str) else 'explicit'}-d{c[5]}-g{c[6]}")
def test_conv2d_against_xla(case):
    H, W, k, s, pad, d, g = case
    rs = np.random.RandomState(H * 100 + W + k)
    C, O = 4, 8
    x = rs.randn(2, H, W, C).astype(np.float32)
    kern = rs.randn(k, k, C // g, O).astype(np.float32)
    bias = rs.randn(O).astype(np.float32)
    ref = jax_conv(x, kern, s, pad, d, g, 2) + bias
    if g == 1:  # JAX's own conv2d where it takes the arguments
        jp = {"kernel": kern, "bias": bias}
        np.testing.assert_allclose(
            np.asarray(JB.conv2d(jp, x, stride=s, padding=pad, dilation=d)), ref, atol=ATOL)
    got = PB.conv2d({"kernel": t(kern), "bias": t(bias)}, t(x), stride=s, padding=pad,
                    dilation=d, groups=g)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("n", [9, 10, 224, 7])
def test_same_padding_is_xla_split_at_stride_2(n):
    """XLA's "SAME" at stride 2 pads (total // 2, total - total // 2), total
    = max((ceil(n / 2) - 1) * 2 + k - n, 0): one more at the end when the
    total is odd; torch's padding="same" refuses stride > 1."""
    for k in (1, 2, 3, 7):
        total = max((-(-n // 2) - 1) * 2 + k - n, 0)
        pads = PB.conv_padding("SAME", (n,), (k,), (2,), (1,))
        assert pads == ((total // 2, total - total // 2),)
        x = np.random.RandomState(k).randn(1, n, n, 2).astype(np.float32)
        kern = np.random.RandomState(k + 1).randn(k, k, 2, 3).astype(np.float32)
        np.testing.assert_allclose(PB.conv2d({"kernel": t(kern)}, t(x), stride=2).numpy(),
                                   jax_conv(x, kern, 2, "SAME", 1, 1, 2), atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 12, 12, 16, 8, 3), (1, 7, 9, 8, 4, 1),
                                   (2, 56, 56, 64, 64, 3)])
def test_stride1_same_callers_bit_identical(shape):
    """conv2d's existing callers (the AVS head's stride-1 "SAME"
    convolutions) give what the stride-1-only conv2d gave, bit for bit."""
    B, H, W, C, O, k = shape
    rs = np.random.RandomState(H)
    x = t(rs.randn(B, H, W, C).astype(np.float32))
    p = {"kernel": t(rs.randn(k, k, C, O).astype(np.float32)),
         "bias": t(rs.randn(O).astype(np.float32))}
    w = p["kernel"].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    old = F.conv2d(x.permute(0, 3, 1, 2), w, p["bias"], padding="same").permute(0, 2, 3, 1)
    assert torch.equal(PB.conv2d(p, x), old)
    assert torch.equal(PB.conv2d(p, x, stride=1, padding="SAME"), old)


# (T, H, W, kernel (t, h, w), stride, padding)
CONV3D_CASES = [((8, 12, 12), (1, 7, 7), (1, 2, 2), ((0, 0), (3, 3), (3, 3))),
                ((8, 6, 6), (3, 1, 1), (2, 1, 1), ((1, 1), (0, 0), (0, 0))),
                ((4, 6, 6), (1, 1, 1), (2, 2, 2), "VALID"),
                ((5, 7, 6), (3, 3, 3), (2, 2, 1), "SAME")]


@pytest.mark.parametrize("case", CONV3D_CASES, ids=["stem_s", "temporal", "down", "same"])
def test_conv3d_against_xla(case):
    (T, H, W), k, s, pad = case
    rs = np.random.RandomState(T + H)
    x = rs.randn(2, T, H, W, 3).astype(np.float32)
    kern = rs.randn(*k, 3, 5).astype(np.float32)
    ref = jax_conv(x, kern, s, pad, 1, 1, 3)
    np.testing.assert_allclose(PB.conv3d({"kernel": t(kern)}, t(x), stride=s, padding=pad).numpy(),
                               ref, atol=ATOL)


@pytest.mark.parametrize("hw", [(9, 9), (10, 11), (112, 112)])
def test_max_pool_against_reduce_window(hw):
    x = np.random.RandomState(hw[0]).randn(2, *hw, 3).astype(np.float32)
    ref = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                                [(0, 0), (1, 1), (1, 1), (0, 0)])
    np.testing.assert_array_equal(PB.max_pool2d(t(x), 3, 2, ((1, 1), (1, 1))).numpy(),
                                  np.asarray(ref))
    ref2 = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    np.testing.assert_array_equal(PB.max_pool2d(t(x), 2, 2).numpy(), np.asarray(ref2))


# ---------------------------------------------------------------------------
# backbones: the port's seeded weights in both packages
# ---------------------------------------------------------------------------

def scramble_bn(tree, rs):
    """Every inference BN of a port tree given seeded statistics, scale and
    shift away from the identity."""
    if isinstance(tree, list):
        for v in tree:
            scramble_bn(v, rs)
    elif isinstance(tree, dict) and set(tree) == {"scale", "bias", "mean", "var"}:
        n = tree["mean"].shape[0]
        tree.update(mean=t((0.1 * rs.randn(n)).astype(np.float32)),
                    var=t((0.5 + rs.rand(n)).astype(np.float32)),
                    scale=t((1 + 0.2 * rs.randn(n)).astype(np.float32)),
                    bias=t((0.1 * rs.randn(n)).astype(np.float32)))
    elif isinstance(tree, dict):
        for v in tree.values():
            scramble_bn(v, rs)
    return tree


@pytest.fixture(scope="module")
def resnet():
    p = scramble_bn(PV.init_resnet152(PB.seeded_init(0, "cpu")), np.random.RandomState(0))
    return p, numpy_tree(p)


@pytest.fixture(scope="module")
def r2p1d():
    p = scramble_bn(PV.init_r2plus1d_18(PB.seeded_init(1, "cpu")), np.random.RandomState(1))
    return p, numpy_tree(p)


def close_model(got, ref):
    np.testing.assert_allclose(got, ref, atol=MODEL_RTOL * np.abs(ref).max(), rtol=0)


def test_resnet_bottleneck(resnet):
    """layer2's first bottleneck (stride 2, downsample) against JAX's
    pieces, with running statistics away from the identity."""
    p, pn = resnet
    blk, bn = p["layer2"][0], pn["layer2"][0]
    x = np.random.RandomState(3).randn(2, 16, 16, 256).astype(np.float32)

    def jax_blk(x):
        y = jax.nn.relu(JV._bn(bn["bn1"], JV._c2d(bn["conv1"], x)))
        y = jax.nn.relu(JV._bn(bn["bn2"], JV._c2d(bn["conv2"], y, stride=2, pad=1)))
        y = JV._bn(bn["bn3"], JV._c2d(bn["conv3"], y))
        return np.asarray(jax.nn.relu(y + JV._bn(bn["down_bn"],
                                                 JV._c2d(bn["down_conv"], x, stride=2))))

    xt = t(x)
    y = torch.relu(PV._bn(blk["bn1"], PV._c2d(blk["conv1"], xt)))
    y = torch.relu(PV._bn(blk["bn2"], PV._c2d(blk["conv2"], y, stride=2, pad=1)))
    y = PV._bn(blk["bn3"], PV._c2d(blk["conv3"], y))
    got = torch.relu(y + PV._bn(blk["down_bn"], PV._c2d(blk["down_conv"], xt, stride=2)))
    close_model(got.numpy(), jax_blk(x))


def test_r2plus1d_stem_and_block(r2p1d):
    p, pn = r2p1d
    x = np.random.RandomState(4).randn(2, 8, 16, 16, 3).astype(np.float32)
    jy = JV._c3d(pn["stem_s"], x, (1, 2, 2), (0, 3, 3))
    jy = jax.nn.relu(JV._bn(pn["stem_bn_s"], jy))
    jy = jax.nn.relu(JV._bn(pn["stem_bn_t"], JV._c3d(pn["stem_t"], jy, (1, 1, 1), (1, 0, 0))))
    py = PV._c3d(p["stem_s"], t(x), (1, 2, 2), (0, 3, 3))
    py = torch.relu(PV._bn(p["stem_bn_s"], py))
    py = torch.relu(PV._bn(p["stem_bn_t"], PV._c3d(p["stem_t"], py, (1, 1, 1), (1, 0, 0))))
    close_model(py.numpy(), np.asarray(jy))
    h = np.random.RandomState(5).randn(2, 8, 8, 8, 64).astype(np.float32)
    for ci, stride in ((1, 2), (2, 1)):  # layer2's first block: strided, then not
        x = h if ci == 1 else np.random.RandomState(6).randn(2, 4, 4, 4, 128).astype(np.float32)
        close_model(PV._conv2plus1d(p["layer2"][0], ci, t(x), stride).numpy(),
                    np.asarray(JV._conv2plus1d(pn["layer2"][0], ci, x, stride)))
    assert PV._midplanes(64, 128) == JV._midplanes(64, 128) == 230
    assert p["layer2"][0]["conv1_s"]["kernel"].shape[-1] == 230


def test_resnet152_whole(resnet):
    p, pn = resnet
    x = np.random.RandomState(6).randn(2, 32, 32, 3).astype(np.float32)
    got = PV.resnet152_features(p, t(x)).numpy()
    assert got.shape == (2, 2048)
    close_model(got, np.asarray(JV.resnet152_features(pn, x)))


def test_r2plus1d_18_whole(r2p1d):
    p, pn = r2p1d
    x = np.random.RandomState(7).randn(1, 8, 32, 32, 3).astype(np.float32)
    got = PV.r2plus1d_18_features(p, t(x)).numpy()
    assert got.shape == (1, 512)
    close_model(got, np.asarray(JV.r2plus1d_18_features(pn, x)))


def torchvision_state(pn, kind):
    """A torchvision state dict holding the numpy tree `pn` (the inverse of
    the converters' renames and transposes), with a dropped fc."""
    sd = {"fc.weight": np.zeros((3, 2), np.float32)}
    conv = lambda k: np.ascontiguousarray(np.moveaxis(k, (-2, -1), (1, 0)))

    def bn(prefix, b):
        sd.update({f"{prefix}.weight": b["scale"], f"{prefix}.bias": b["bias"],
                   f"{prefix}.running_mean": b["mean"], f"{prefix}.running_var": b["var"]})

    if kind == "resnet":
        sd["conv1.weight"] = conv(pn["conv1"]["kernel"])
        bn("bn1", pn["bn1"])
        for li in range(1, 5):
            for b, blk in enumerate(pn[f"layer{li}"]):
                base = f"layer{li}.{b}"
                for i in (1, 2, 3):
                    sd[f"{base}.conv{i}.weight"] = conv(blk[f"conv{i}"]["kernel"])
                    bn(f"{base}.bn{i}", blk[f"bn{i}"])
                if "down_conv" in blk:
                    sd[f"{base}.downsample.0.weight"] = conv(blk["down_conv"]["kernel"])
                    bn(f"{base}.downsample.1", blk["down_bn"])
        return sd
    sd["stem.0.weight"] = conv(pn["stem_s"]["kernel"])
    bn("stem.1", pn["stem_bn_s"])
    sd["stem.3.weight"] = conv(pn["stem_t"]["kernel"])
    bn("stem.4", pn["stem_bn_t"])
    for li in range(1, 5):
        for b, blk in enumerate(pn[f"layer{li}"]):
            base = f"layer{li}.{b}"
            for ci in (1, 2):
                sd[f"{base}.conv{ci}.0.0.weight"] = conv(blk[f"conv{ci}_s"]["kernel"])
                bn(f"{base}.conv{ci}.0.1", blk[f"bn{ci}_s"])
                sd[f"{base}.conv{ci}.0.3.weight"] = conv(blk[f"conv{ci}_t"]["kernel"])
                bn(f"{base}.bn{ci}", blk[f"bn{ci}"])
            if "down_conv" in blk:
                sd[f"{base}.downsample.0.weight"] = conv(blk["down_conv"]["kernel"])
                bn(f"{base}.downsample.1", blk["down_bn"])
    return sd


@pytest.mark.parametrize("kind", ["resnet", "r2plus1d"])
def test_from_torch_trees_against_jax(kind, resnet, r2p1d):
    """Both converters give JAX's tree leaf for leaf, the tree the port
    started from, and `from_jax_tree` carries JAX's tree onto the port's
    leaf by leaf."""
    _, pn = resnet if kind == "resnet" else r2p1d
    sd = torchvision_state(pn, kind)
    jconv, pconv = ((JV.resnet152_from_torch, PV.resnet152_from_torch) if kind == "resnet"
                    else (JV.r2plus1d_18_from_torch, PV.r2plus1d_18_from_torch))
    jt, pt = jconv(sd), pconv(sd)
    jpaths, ppaths = tree_paths(jax.tree_util.tree_map(np.asarray, jt)), tree_paths(pt)
    assert [k for k, _ in jpaths] == [k for k, _ in ppaths] == [k for k, _ in tree_paths(pn)]
    for (k, a), (_, b), (_, c) in zip(jpaths, ppaths, tree_paths(pn)):
        assert b.dtype == np.float32, k
        np.testing.assert_array_equal(a, b, err_msg=str(k))
        np.testing.assert_array_equal(b, c, err_msg=str(k))
    init = PV.init_resnet152 if kind == "resnet" else PV.init_r2plus1d_18
    carried = from_jax_tree(jax.tree_util.tree_map(np.asarray, jt), init(PB.seeded_init(0, "meta")),
                            device="cpu")
    assert all(torch.equal(x, t(y)) for (_, x), (_, y) in zip(tree_paths(carried), ppaths))
    jinit = JV.init_resnet152 if kind == "resnet" else JV.init_r2plus1d_18
    shapes = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    assert ([(k, tuple(v.shape)) for k, v in tree_paths(shapes)]
            == [(k, tuple(v.shape)) for k, v in ppaths])


# ---------------------------------------------------------------------------
# feature extraction and preprocessing
# ---------------------------------------------------------------------------

def write_frames(root, videos, n, size, seed=0):
    rs = np.random.RandomState(seed)
    for vid in videos:
        (root / vid).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rs.randint(0, 256, (size, size, 3), dtype=np.uint8)).save(
                root / vid / f"{i + 1:08d}.jpg", quality=90)


@pytest.fixture(scope="module")
def frame_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    write_frames(root / "frames", ["vidA", "vidB"], 20, 40)
    return root


def test_extract_rgb_feats(frame_tree, resnet):
    """(n_frame_steps, 2048) a video through the port, against JAX's
    backbone on JAX's frame loader; the CLI writes the same on the CPU."""
    p, pn = resnet
    out = frame_tree / "rgb"
    vids = PFE.extract_rgb_feats(str(frame_tree / "frames"), str(out), n_frame_steps=12,
                                 img_size=32, params=pn, batch=5, device="cpu")
    assert vids == ["vidA", "vidB"]
    for vid in vids:
        got = np.load(out / f"{vid}.npy")
        assert got.shape == (12, 2048) and got.dtype == np.float32
        paths = JFE._sample_frames(str(frame_tree / "frames" / vid), 12)
        frames = np.stack([JFE._load_frame(q, 32) for q in paths]).astype(np.float32)
        close_model(got, np.asarray(JV.resnet152_features(pn, frames)))


def test_extract_3d_feats_and_cli(frame_tree, r2p1d, tmp_path):
    p, pn = r2p1d
    out = frame_tree / "st"
    vids = PFE.extract_3d_feats(str(frame_tree / "frames"), str(out), n_frame_steps=16,
                                img_size=32, params=p, device="cpu")
    for vid in vids:
        got = np.load(out / f"{vid}.npy")
        assert got.shape == (2, 512)
        paths = JFE._sample_frames(str(frame_tree / "frames" / vid), 16)
        frames = np.stack([JFE._load_frame(q, 32) for q in paths]).astype(np.float32)
        close_model(got, np.asarray(JV.r2plus1d_18_features(pn, frames.reshape(2, 8, 32, 32, 3))))
    ckpt = tmp_path / "r2plus1d_18.pth"
    torch.save({k: t(v) for k, v in torchvision_state(pn, "r2plus1d").items()}, ckpt)
    cli_out = tmp_path / "cli"
    PFE.main(["clip", "--video-path", str(frame_tree / "frames"), "--output-dir", str(cli_out),
              "--n-frame-steps", "8", "--torch-ckpt", str(ckpt), "--device", "cpu"])
    for vid in vids:
        got = np.load(cli_out / f"{vid}.npy")
        assert got.shape == (1, 512) and np.isfinite(got).all()


def test_entry_points_need_the_card(frame_tree, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PFE.extract_3d_feats(str(frame_tree / "frames"), str(tmp_path), n_frame_steps=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PB.seeded_init(0)


@pytest.mark.parametrize("kind", ["int16_stereo_44k1", "float_mono_16k", "int32_mono_32k_short"])
def test_wav_to_wave_npy_bit_for_bit(kind, tmp_path):
    from scipy.io import wavfile

    rs = np.random.RandomState(11)
    if kind == "int16_stereo_44k1":
        sr, data = 44100, (rs.randn(44100 * 3, 2) * 8000).astype(np.int16)
    elif kind == "float_mono_16k":
        sr, data = 16000, (0.3 * rs.randn(16000 * 12)).astype(np.float32)
    else:
        sr, data = 32000, (rs.randn(32000 * 2) * 2e8).astype(np.int32)
    wav = tmp_path / "a.wav"
    wavfile.write(wav, sr, data)
    ref = JPP.wav_to_wave_npy(str(wav), str(tmp_path / "j.npy"))
    got = PPP.wav_to_wave_npy(str(wav), str(tmp_path / "p.npy"))
    assert got.dtype == np.float32 and got.shape == (320000,)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"), np.load(tmp_path / "j.npy"))
    assert PPP.have_ffmpeg() == JPP.have_ffmpeg()
