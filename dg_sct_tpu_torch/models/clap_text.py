"""CLAP's text branch (`dg_sct_tpu/models/clap_text.py`; the reference's
`CLAPTextEncoder`, `pretrain/nets/prompt_learner.py:76-106`): "The sounds
of <name>" through RoBERTa-base (`models/roberta.py`), its pooled output
through CLAP's `text_projection` -> the static text features that
`pretrain.clap_matching` scores audio against.

Weights come from a CLAP checkpoint's `text_branch.*` and
`text_projection.*` keys when given (its `text_transform.*` MLP is loaded
by the reference and never used), else from a seeded initialiser.
Tokenization is the JAX package's byte-level fallback with RoBERTa's
special ids (<s> 0, <pad> 1, </s> 2): the JAX package runs
`transformers.RobertaTokenizer` instead when `roberta-base` is in the local
HF cache, which the port never reads (the card machine has no
`transformers`), so only the fallback's ids agree.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.basic import Init
from . import roberta as R

PROMPT = "The sounds of "
MAX_LEN = 77


def split_clap_text_state(state_dict: Dict[str, object]):
    """A CLAP checkpoint's state dict -> its (text_branch, text_transform,
    text_projection) dicts, each prefix stripped."""
    def strip(prefix):
        n = len(prefix)
        return {k[n:]: v for k, v in state_dict.items() if k.startswith(prefix)}

    return strip("text_branch."), strip("text_transform."), strip("text_projection.")


def tokenize(texts: Sequence[str]):
    """-> (ids, attention mask), int64 (n, MAX_LEN): <s>, each UTF-8 byte b
    as 3 + b mod (VOCAB - 4) (cut to MAX_LEN - 2), </s>, then <pad>."""
    ids = np.ones((len(texts), MAX_LEN), np.int64)
    mask = np.zeros((len(texts), MAX_LEN), np.int64)
    for i, t in enumerate(texts):
        body = [3 + (b % (R.VOCAB - 4)) for b in t.encode("utf-8")]
        seq = [0] + body[: MAX_LEN - 2] + [2]
        ids[i, : len(seq)] = seq
        mask[i, : len(seq)] = 1
    return ids, mask


def compute_clap_text_features(classnames, *, weak=True,
                               clap_state_dict: Optional[dict] = None, seed: int = 0,
                               device=None) -> torch.Tensor:
    """(n_cls, 512) float32 CLAP text features on `device` (None: the card);
    `weak=False` appends a "background" class. A component the state dict
    lacks comes from the initialiser seeded with `seed`."""
    device = resolve_device(device)
    names = list(classnames) + ([] if weak else ["background"])
    branch_state = proj_state = None
    if clap_state_dict is not None:
        branch_state, _, proj_state = split_clap_text_state(clap_state_dict)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init = Init(gen, device)
    params = (R.roberta_from_torch(branch_state, device=device) if branch_state
              else R.init_roberta(init))
    proj = (R.projection_from_torch(proj_state, device=device) if proj_state
            else R.init_text_projection(init))
    ids, mask = tokenize([PROMPT + n for n in names])
    with torch.no_grad():
        _, pooled = R.roberta_encode(params, ids, mask)
        return R.text_projection(proj, pooled).float()
