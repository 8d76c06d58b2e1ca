"""The port's AVE components against DG-SCT's own torch modules, through
the activation goldens (tests/golden/refgold_ave_*, made by
tests/gen_reference_goldens.py; weights and inputs regenerated bit-exactly
by tests/refgold_common.synth): the audio and visual `VisualAdapter`, the
`TemporalAttention` head and CMBS, each through the port's converter, at
tests/test_reference_golden.py's tolerances. The adapters also run folded
for serving, as the engine runs them (K3's plain version on the CPU)."""
import numpy as np
import pytest
import torch

import dg_sct_tpu_torch.configs as PC
from dg_sct_tpu_torch.models import adapter as PAd
from dg_sct_tpu_torch.models.heads import ave as PH
from dg_sct_tpu_torch.utils import torch_convert as PTC
from gen_reference_goldens import ADAPTER_SPECS
from refgold_common import load_census, outputs_path, rebuild_sd, synth
from torch_port_helpers import to_torch


def _load(comp):
    return rebuild_sd(load_census(comp)), np.load(outputs_path(comp))


def close(got, ref, atol, rtol=2e-4, msg=""):
    np.testing.assert_allclose(np.asarray(got), ref, atol=atol, rtol=rtol, err_msg=msg)


@pytest.mark.parametrize("comp", ["ave_adapter_audio", "ave_adapter_visual"])
@pytest.mark.parametrize("folded", [False, True], ids=["train_form", "folded"])
def test_ave_adapter_matches_dgsct_golden(comp, folded):
    dim, N, odim, M, groups, tokens, use_bn, use_gate, B = ADAPTER_SPECS[comp]
    sd, gold = _load(comp)
    params, state = (to_torch(t) for t in PTC.convert_adapter(sd, "m", groups=groups))
    cfg = PC.AdapterConfig(reduction_factor=8, num_tokens=tokens, num_conv_group=groups,
                           use_bn=use_bn, use_gate=use_gate)
    if folded:
        params, state = PAd.fold_eval(params, state, cfg)
    x = synth(f"__in__/{comp}/x", (B, dim, N, 1), is_input=True)
    vt = synth(f"__in__/{comp}/vt", (B, odim, M, 1), is_input=True)
    out, maps, _ = PAd.adapter(params, state,
                               torch.from_numpy(x[:, :, :, 0].transpose(0, 2, 1).copy()),
                               torch.from_numpy(vt[:, :, :, 0].transpose(0, 2, 1).copy()),
                               cfg, kernels=folded)
    close(out, gold["out"][:, :, :, 0].transpose(0, 2, 1), atol=2e-5)
    close(maps, gold["maps"], atol=2e-6)


def test_temporal_attention_matches_dgsct_golden():
    sd, gold = _load("ave_temporal_attention")
    params = to_torch(PTC.convert_temporal_attention(sd, pre="m"))
    f_v = synth("__in__/ave_ta/f_v", (3, 10, 1536), is_input=True)
    f_a = synth("__in__/ave_ta/f_a", (3, 10, 768), is_input=True)
    with torch.inference_mode():
        v_out, a_out, gate = PH.temporal_attention(params, torch.from_numpy(f_v),
                                                   torch.from_numpy(f_a))
    close(v_out, gold["v_out"], atol=5e-5, msg="v_out")
    close(a_out, gold["a_out"], atol=5e-5, msg="a_out")
    close(gate, gold["gate"], atol=5e-5, msg="gate")


def test_cmbs_matches_dgsct_golden():
    sd, gold = _load("ave_cmbs")
    params = to_torch(PTC.convert_cmbs(sd, pre="m"))
    v = synth("__in__/ave_cmbs/v", (10, 3, 256), is_input=True)
    a = synth("__in__/ave_cmbs/a", (10, 3, 256), is_input=True)
    is_ev, ev, av = PH.cmbs(params, torch.from_numpy(v), torch.from_numpy(a))
    close(is_ev, gold["is_event"], atol=2e-5, msg="is_event")
    close(ev, gold["event"], atol=2e-5, msg="event")
    close(av, gold["av"], atol=2e-5, msg="av")
