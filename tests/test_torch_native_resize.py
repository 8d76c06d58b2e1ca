"""The port's `native.resize_normalize` (one decoded image; the C function
`dgsct_resize_normalize` of `dg_sct_tpu_torch/native/io_core.cpp`) against
the JAX package's `dg_sct_tpu.native.resize_normalize`, bit for bit, on the
images of tests/test_native_io.py: a downscale to 192 and an upscale to 224.
"""
import numpy as np
import pytest

import dg_sct_tpu.native as JN
import dg_sct_tpu_torch.native as PN

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)

pytestmark = pytest.mark.skipif(not (JN.available() and PN.available()),
                                reason="a native io core is unavailable")


@pytest.mark.parametrize("seed,shape,size", [(0, (356, 473, 3), 192), (1, (96, 128, 3), 224)])
def test_resize_normalize_matches_jax_bit_for_bit(seed, shape, size):
    img = (np.random.RandomState(seed).rand(*shape) * 255).astype(np.uint8)
    ours = PN.resize_normalize(img, size, MEAN, STD)
    ref = JN.resize_normalize(img, size, MEAN, STD)
    assert ours.shape == ref.shape == (size, size, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_resize_normalize_refuses_a_grey_image():
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        PN.resize_normalize(np.zeros((8, 8), np.uint8), 4, MEAN, STD)
