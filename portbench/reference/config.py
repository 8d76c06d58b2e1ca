"""The sizes of a configuration file (`portbench/configs/<name>.json`,
key "model"), read as plain attributes with the few sizes derived from
them. The field names are those of the DG-SCT release's options (Swin-V2-L
`swinv2_large_window12_192_22k`, HTS-AT, the `VisualAdapter`)."""
from __future__ import annotations

from types import SimpleNamespace


class Tower(SimpleNamespace):
    """A Swin tower: `embed_dim`, `depths`, `num_heads`, `window_size`,
    `mlp_ratio`, the input `img_size` (Swin-V2) or `spec_size` (HTS-AT) and
    the patch size."""

    @property
    def num_layers(self):
        return len(self.depths)

    @property
    def num_features(self):
        return self.stage_dim(self.num_layers - 1)

    def stage_dim(self, s):
        return int(self.embed_dim * 2 ** s)

    def stage_resolution(self, s):
        side = getattr(self, "img_size", None) or self.spec_size
        r = side // self.patch_size // 2 ** s
        return (r, r)

    def plan(self):
        """Per stage, per block: dim, heads, res, ws, shift, hidden (the
        timm constructor's rule: no shift where the stage fits one window)."""
        out = []
        for s in range(self.num_layers):
            res = self.stage_resolution(s)
            ws = min(self.window_size, min(res))
            out.append([dict(dim=self.stage_dim(s), heads=self.num_heads[s], res=res, ws=ws,
                             shift=0 if min(res) <= self.window_size or d % 2 == 0 else ws // 2,
                             hidden=int(self.stage_dim(s) * self.mlp_ratio),
                             pretrained_ws=(getattr(self, "pretrained_window_sizes", None)
                                            or [0] * self.num_layers)[s])
                        for d in range(self.depths[s])])
        return out


class Frontend(SimpleNamespace):
    @property
    def clip_samples(self):
        return self.sample_rate * self.clip_seconds

    @property
    def freq_ratio(self):
        return self.spec_size // self.mel_bins

    @property
    def target_t(self):
        return self.spec_size * self.freq_ratio


def load(model: dict, gelu: str) -> SimpleNamespace:
    """The "model" object of a configuration file -> a namespace whose
    `swin`, `htsat` (with `frontend`), `adapter` and `adapter_vis` carry
    their sizes as attributes; `gelu` ("exact" or "tanh") is the towers'
    GELU as the configuration serves it."""
    m = dict(model, gelu=gelu)
    h = dict(m["htsat"])
    fe = Frontend(**h.pop("frontend"))
    m["swin"] = Tower(**m["swin"])
    m["htsat"] = Tower(frontend=fe, **h)
    m["adapter"] = SimpleNamespace(**m["adapter"])
    m["adapter_vis"] = SimpleNamespace(**m["adapter_vis"]) if "adapter_vis" in m else m["adapter"]
    return SimpleNamespace(**m)


def paired_layout(cfg):
    """Per stage, (visual block, audio block or None, adapter index or
    None): blocks pair 1:1 where the towers' depths agree; where the visual
    stage has three times the audio blocks, audio block j sits beside
    visual block 3j + 2 and the others run alone (DG-SCT's `net_trans.py`)."""
    plan, ai = [], 0
    for s in range(cfg.swin.num_layers):
        vd, ad = cfg.swin.depths[s], cfg.htsat.depths[s]
        at = {b: b for b in range(vd)} if vd == ad else {3 * j + 2: j for j in range(ad)}
        if vd != ad and 3 * ad != vd:
            raise ValueError(f"stage {s}: {vd} visual blocks against {ad} audio blocks")
        stage = []
        for b in range(vd):
            if b in at:
                stage.append((b, at[b], ai))
                ai += 1
            else:
                stage.append((b, None, None))
        plan.append(stage)
    return plan
