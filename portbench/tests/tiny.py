"""Tiny configurations of the benchmark's two model kinds, and a checkout
that runs every cell at them on the CPU in float32."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_AVE = {
    "swin": {"img_size": 64, "patch_size": 4, "in_chans": 3, "embed_dim": 16,
             "depths": [1, 1, 3, 1], "num_heads": [2, 2, 2, 2], "window_size": 4,
             "mlp_ratio": 4.0, "drop_path_rate": 0.0, "pretrained_window_sizes": [0, 0, 0, 0]},
    "htsat": {"spec_size": 32, "patch_size": 4, "patch_stride": [4, 4], "in_chans": 1,
              "embed_dim": 8, "depths": [1, 1, 1, 1], "num_heads": [2, 2, 2, 2],
              "window_size": 4, "mlp_ratio": 4.0, "qkv_bias": True, "drop_path_rate": 0.0,
              "num_classes": 527, "ape": False, "patch_norm": True,
              "frontend": {"sample_rate": 3200, "clip_seconds": 1, "n_fft": 256,
                           "hop_size": 320, "mel_bins": 16, "fmin": 50.0, "fmax": 1500.0,
                           "amin": 1e-10, "time_drop_width": 8, "time_stripes_num": 2,
                           "freq_drop_width": 8, "freq_stripes_num": 2, "spec_size": 32}},
    "adapter": {"reduction_factor": 2, "num_tokens": 4, "num_conv_group": 2, "use_bn": True,
                "use_gate": True, "is_before_layernorm": True, "is_post_layernorm": True,
                "is_multimodal": True, "alpha": 0.3, "beta": 0.05, "avs_variant": False},
    "num_frames": 2, "num_classes": 28, "d_model": 256}

TINY_AVS = copy.deepcopy(TINY_AVE)
del TINY_AVS["num_classes"], TINY_AVS["d_model"]
TINY_AVS["adapter"] = dict(TINY_AVE["adapter"], use_bn=False, use_gate=False, avs_variant=True)
TINY_AVS["adapter_vis"] = dict(TINY_AVE["adapter"], use_bn=False, use_gate=True, avs_variant=True)
TINY_AVS.update(channel=32, mask_size=64, scale_sizes=[16, 8, 4, 2], tpavi_stages=[0, 3],
                tpavi_vv_flag=False, tpavi_va_flag=True)

TINY = {"ave": TINY_AVE, "avs": TINY_AVS}


def tiny_checkout(root: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ under `root` whose
    configurations are the tiny ones, served in float32 with exact GELU, so
    the program's answers sit ~1e-6 from the reference's; the limits stay."""
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out", ".cache"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = root / c["file"]
        conf = json.loads(path.read_text())
        conf["model"] = TINY[conf["kind"]]
        conf["serve"].update(dtype="float32", gelu="exact")
        if "stft_bf16" in conf["serve"]:
            conf["serve"]["stft_bf16"] = False
        conf["reference_block"] = 4
        path.write_text(json.dumps(conf))
    return root
