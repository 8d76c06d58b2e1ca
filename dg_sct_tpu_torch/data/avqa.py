"""MUSIC-AVQA data: the question and answer vocabularies, question parsing
and tokenizing, the map-style dataset, the per-type accuracy table and a
seeded synthetic batch (`dg_sct_tpu/data/avqa.py`; the reference is
DG-SCT's `net_grd_avst/dataloader_avst.py`).

Items: `visual_posi` and `visual_nega` (T, H, W, 3) ImageNet-normalized
float32 frames of the video and of another one, `wave` (T, L) (float32, or
int16 PCM kept for the device), `question` (14,) int64 token ids padded with
`<pad>` (0), `answer` the answer's index and `type` the json's
'["Modality", "SubType"]' string.
"""
from __future__ import annotations

import ast
import json
import os
from typing import List, Optional

import numpy as np

from .ave import load_frames, load_wave

MAX_QST_LEN = 14


def load_vocab(path: str) -> List[str]:
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if ln.rstrip("\n")]


def build_vocabs(train_json: str):
    """The vocabularies as the reference builds them from the train split:
    '<pad>' first, then the words of the template-substituted questions in
    order of first appearance; the answers in order of first appearance
    (93 question words and 42 answers on MUSIC-AVQA)."""
    with open(train_json) as f:
        samples = json.load(f)
    ques_vocab, ans_vocab = ["<pad>"], []
    for s in samples:
        for wd in parse_question(s):
            if wd not in ques_vocab:
                ques_vocab.append(wd)
        if s["anser"] not in ans_vocab:
            ans_vocab.append(s["anser"])
    return ques_vocab, ans_vocab


def parse_question(sample: dict) -> List[str]:
    """The question's words, the trailing '?' stripped and each '<...>'
    placeholder replaced by the next of the sample's `templ_values`."""
    words = sample["question_content"].rstrip().split(" ")
    words[-1] = words[-1][:-1]
    p = 0
    templ = ast.literal_eval(sample["templ_values"])
    for i in range(len(words)):
        if "<" in words[i]:
            words[i] = templ[p]
            p += 1
    return words


def tokenize(words: List[str], word_to_ix: dict, max_len: int = MAX_QST_LEN) -> np.ndarray:
    """Token ids, an unknown word as 0, cut at `max_len` and padded with
    `<pad>`'s id."""
    idxs = [word_to_ix.get(w, 0) for w in words][:max_len]
    idxs += [word_to_ix["<pad>"]] * (max_len - len(idxs))
    return np.asarray(idxs, np.int64)


class AVQADataset:
    """One item a question of `split_json`. The vocabularies come from
    `meta_root`'s ques_vocab.txt and ans_vocab.txt, or, without the first,
    are built from the train split's json (and ans_vocab.txt where it is).
    The negative video of item i is drawn from the dataset's own
    `np.random.RandomState(seed)` when the item is read, as the JAX package
    draws it: on sequential reads both draw the same videos.
    `with_nega=False` draws it all the same but loads no frames for it
    (serving and the stage-2 eval step read none)."""

    def __init__(self, meta_root: str, split_json: str, frame_dir: Optional[str] = None,
                 audio_dir: Optional[str] = None, img_size: int = 192,
                 num_frames: int = 10, segment_samples: int = 32000, seed: int = 0,
                 with_nega: bool = True):
        ques_path = os.path.join(meta_root, "ques_vocab.txt")
        if os.path.exists(ques_path):
            self.ques_vocab = load_vocab(ques_path)
            self.ans_vocab = load_vocab(os.path.join(meta_root, "ans_vocab.txt"))
        else:
            train_json = next(p for p in (
                os.path.join(meta_root, "json", "avqa-train.json"),
                os.path.join(meta_root, "avqa-train.json"),
                os.path.join(os.path.dirname(split_json), "avqa-train.json"))
                if os.path.exists(p))
            self.ques_vocab, built_ans = build_vocabs(train_json)
            ans_path = os.path.join(meta_root, "ans_vocab.txt")
            self.ans_vocab = load_vocab(ans_path) if os.path.exists(ans_path) else built_ans
        self.word_to_ix = {w: i for i, w in enumerate(self.ques_vocab)}
        self.ans_to_ix = {w: i for i, w in enumerate(self.ans_vocab)}
        with open(split_json) as f:
            self.samples = json.load(f)
        self.frame_dir = frame_dir
        self.audio_dir = audio_dir
        self.img_size = img_size
        self.num_frames = num_frames
        self.segment_samples = segment_samples
        self.with_nega = with_nega
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        s = self.samples[i]
        vid = s["video_id"]
        j = self.rng.randint(len(self.samples) - 1)  # any other question's video
        if j >= i:
            j += 1
        frames = lambda v: load_frames(self.frame_dir, v, self.num_frames, self.img_size)
        item = {"visual_posi": frames(vid),
                "wave": load_wave(self.audio_dir, vid, self.num_frames, self.segment_samples),
                "question": tokenize(parse_question(s), self.word_to_ix),
                "answer": np.int64(self.ans_to_ix[s["anser"]]),
                "type": s.get("type", "")}
        if self.with_nega:
            item["visual_nega"] = frames(self.samples[j]["video_id"])
        return item


def question_type_accuracies(types, correct):
    """Accuracy in % per '["Modality", "SubType"]' type, per modality and
    over all ("Avg"), as the reference's test report groups them; a type
    string that does not parse counts as "Unknown/Unknown"."""
    buckets = {}
    for t, c in zip(types, correct):
        try:
            modality, sub = ast.literal_eval(t)
        except (ValueError, SyntaxError):
            modality, sub = "Unknown", "Unknown"
        key = f"{modality}/{sub}"
        buckets.setdefault(key, []).append(c)
        buckets.setdefault(modality, []).append(c)
    buckets["Avg"] = list(correct)
    return {k: 100.0 * float(np.mean(v)) for k, v in buckets.items()}


def synthetic_batch(batch_size: int, *, img_size=192, num_frames=10, seed=0, sr=32000):
    """A seeded AVQA batch, JAX's (whose sr is fixed at 32000): waves of `sr`
    samples a segment, frames in [0, 1), questions over 93 words, answers
    over 42."""
    rs = np.random.RandomState(seed)
    return {
        "wave": rs.randn(batch_size, num_frames, sr).astype(np.float32) * 0.1,
        "visual_posi": rs.rand(batch_size, num_frames, img_size, img_size, 3).astype(np.float32),
        "visual_nega": rs.rand(batch_size, num_frames, img_size, img_size, 3).astype(np.float32),
        "question": rs.randint(0, 93, size=(batch_size, MAX_QST_LEN)),
        "answer": rs.randint(0, 42, size=(batch_size,)),
    }
