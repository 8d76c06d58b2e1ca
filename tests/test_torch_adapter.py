"""The port's DG-SCT adapter (dg_sct_tpu_torch.models.adapter) against the
JAX package's: unfolded, after `fold_eval`, and with stage 5 on K3's plain
version, on the same numpy inputs in float32 (JAX matmul precision
"highest"). Tolerance: atol 1e-4, rtol 1e-3."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.configs import AdapterConfig as JAdapterConfig
from dg_sct_tpu.models import adapter as JA
from dg_sct_tpu_torch.configs import AdapterConfig as PAdapterConfig
from dg_sct_tpu_torch.models import adapter as PA
from torch_port_helpers import to_numpy, to_torch

ATOL, RTOL = 1e-4, 1e-3

# (dim, other_dim, tokens_self, tokens_other): stage 1 of the first takes
# the exact align-first reorder, the second resamples tokens first
GEOMETRIES = [(32, 16, 64, 16), (16, 32, 16, 64)]


def close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=ATOL, rtol=RTOL)


def _adapter(geom, seed):
    dim, other_dim, n_self, n_other = geom
    p, s = JA.init_adapter(jax.random.PRNGKey(seed), dim=dim, other_dim=other_dim,
                           num_tokens_self=n_self, num_tokens_other=n_other,
                           cfg=JAdapterConfig())
    p, s = to_numpy(p), to_numpy(s)
    rs = np.random.RandomState(seed)
    p["gate"] = np.asarray([0.7], np.float32)
    p["gate_av"] = np.asarray([0.4], np.float32)
    for bn in ("bn1", "bn2"):
        n = p[bn]["scale"].shape[0]
        p[bn] = {"scale": (1.0 + 0.2 * rs.randn(n)).astype(np.float32),
                 "bias": (0.1 * rs.randn(n)).astype(np.float32)}
        s[bn] = {"mean": (0.1 * rs.randn(n)).astype(np.float32),
                 "var": (0.5 + rs.rand(n)).astype(np.float32), "count": s[bn]["count"]}
    x = rs.randn(2, n_self, dim).astype(np.float32)
    other = rs.randn(2, n_other, other_dim).astype(np.float32)
    return p, s, x, other


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_adapter_unfolded(geom):
    p, s, x, other = _adapter(geom, seed=1)
    ref, ref_maps, _ = JA.adapter(p, s, jnp.asarray(x), jnp.asarray(other), JAdapterConfig())
    got, maps, _ = PA.adapter(to_torch(p), to_torch(s), torch.from_numpy(x),
                              torch.from_numpy(other), PAdapterConfig())
    close(got, ref)
    close(maps, ref_maps)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_fold_eval_matches_jax(geom):
    p, s, _, _ = _adapter(geom, seed=2)
    jfp, jfs = JA.fold_eval(p, s, JAdapterConfig())
    pfp, pfs = PA.fold_eval(to_torch(p), to_torch(s), PAdapterConfig())
    jfp = to_numpy(jfp)
    assert sorted(pfp) == sorted(jfp) and sorted(pfs) == sorted(jfs)
    for name in ("down", "up", "ln_post"):
        for leaf in jfp[name]:
            close(pfp[name][leaf], jfp[name][leaf])


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("kernels", [False, True])
def test_adapter_folded(geom, kernels):
    """Folded adapter vs the JAX package with the fused-bottleneck flag on
    (Pallas interpret mode on the CPU); kernels=True runs stage 5 through
    K3's wrapper, which takes the plain version for CPU tensors."""
    p, s, x, other = _adapter(geom, seed=3)
    unfolded, _, _ = JA.adapter(p, s, jnp.asarray(x), jnp.asarray(other), JAdapterConfig())
    fp, fs = JA.fold_eval(p, s, JAdapterConfig())
    JA.set_fused_bottleneck(True)
    try:
        ref, ref_maps, _ = JA.adapter(fp, fs, jnp.asarray(x), jnp.asarray(other),
                                      JAdapterConfig())
    finally:
        JA.set_fused_bottleneck(False)
    pfp, pfs = PA.fold_eval(to_torch(p), to_torch(s), PAdapterConfig())
    got, maps, _ = PA.adapter(pfp, pfs, torch.from_numpy(x), torch.from_numpy(other),
                              PAdapterConfig(), kernels=kernels)
    close(got, ref)
    close(got, unfolded)
    close(maps, ref_maps)


def test_avs_variant_is_not_ported(monkeypatch):
    """The AVS variant runs and matches JAX's (tests/test_torch_avs.py also
    holds it against DG-SCT's goldens); what stays unported is a K3 route
    for it, which the JAX package lacks: with kernels on, it never reaches
    K3."""
    p, s, x, other = _adapter(GEOMETRIES[0], seed=4)
    p = {k: v for k, v in p.items() if k not in ("bn1", "bn2")}
    ref, ref_maps, _ = JA.adapter(p, {}, jnp.asarray(x), jnp.asarray(other),
                                  JAdapterConfig(use_bn=False, avs_variant=True))

    def no_k3(*args, **kw):
        raise AssertionError("an AVS adapter reached K3")

    monkeypatch.setattr(PA, "fused_bottleneck", no_k3)
    got, maps, _ = PA.adapter(to_torch(p), {}, torch.from_numpy(x), torch.from_numpy(other),
                              PAdapterConfig(use_bn=False, avs_variant=True), kernels=True)
    close(got, ref)
    close(maps, ref_maps)
